"""The stream's frame cursor (the counterpart of the frame-cursor half of
the JAX package's train/checkpoint.py; the training checkpoints wait for
the port's training loop).

The file is the JAX package's: JSON {"cursor": n, ...}, so a cursor
written by either package resumes the other."""

from __future__ import annotations

import json
import os


def save_frame_cursor(path: str, cursor: int, meta: dict | None = None) -> None:
    """Stream-resume cursor for the batch pipeline (SURVEY.md §5
    'streaming video configs can checkpoint a frame cursor'), written to a
    temporary file and renamed into place, so a reader never sees half."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"cursor": cursor, **(meta or {})}, f)
    os.replace(tmp, path)


def load_frame_cursor(path: str) -> int:
    """A missing or torn cursor file means frame 0: resume must never fail
    on the state it exists to recover from."""
    if not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            return int(json.load(f)["cursor"])
    except (ValueError, KeyError, TypeError, OSError):
        return 0
