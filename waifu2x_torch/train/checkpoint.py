"""Checkpoint / resume (the counterpart of the JAX package's
train/checkpoint.py): the training state and the stream's frame cursor.

Both files are the JAX package's, so either package resumes the other's run.

The training state is a flat .npz, written to `path + ".tmp.npz"` and
renamed into place: `__step__` (int64) and `leaf_i` in the order
`jax.tree.flatten({"params": params, "opt_state": opt_state})` gives for
the optax chain of TrainConfig.make_optimizer, dict keys sorted:
  Adam's update count (int32);
  the first moments, each layer's "b" then "w";
  the second moments, in the same order;
  the schedule's update count (int32), only where the rate is scheduled;
  the params, each layer's "b" then "w".
Clipping holds no state. The port's Adam keeps its count as a float tensor
per leaf (torch.optim.Adam) and OptState.count; both are the one int32
count in the file.

The cursor is JSON {"cursor": n, ...}."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from waifu2x_torch.train.train import OptState, leaves


def _opt_leaves(opt_state: OptState) -> list:
    count = np.asarray(opt_state.count, np.int32)
    pairs = [opt_state.moments(t) for t in leaves(opt_state.params)]
    out = [count] + [m for m, _ in pairs] + [v for _, v in pairs]
    if opt_state.optimizer.scheduled:
        out.append(count)
    return out


def save_checkpoint(path: str, params, opt_state: OptState, step: int) -> None:
    """Atomic .npz snapshot of the full training state (params, Adam's
    moments and count, the step)."""
    flat = _opt_leaves(opt_state) + leaves(params)
    arrays = {f"leaf_{i}": (x.detach().cpu().numpy()
                            if isinstance(x, torch.Tensor) else x)
              for i, x in enumerate(flat)}
    arrays["__step__"] = np.asarray(step, np.int64)
    tmp = path + ".tmp.npz"  # explicit .npz so np.savez doesn't rename
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, params_like, opt_state_like: OptState):
    """Restore (params, opt_state, step). The _like arguments give the
    structure, as in the JAX package, and here also the storage: the values
    are copied into params_like's leaves (the tensors that
    opt_state_like's torch.optim.Adam updates) and into opt_state_like,
    and those two come back."""
    n = len(leaves(params_like))
    scheduled = opt_state_like.optimizer.scheduled
    with np.load(path) as data:
        step = int(data["__step__"])
        want = 1 + 3 * n + scheduled
        got = sum(k.startswith("leaf_") for k in data.files)
        if got != want:
            raise ValueError(f"{path}: {got} leaves, the state has {want}")
        flat = [data[f"leaf_{i}"] for i in range(want)]
    count = int(flat[0])
    with torch.no_grad():
        for t, v in zip(leaves(params_like), flat[1 + 2 * n + scheduled:]):
            t.copy_(torch.from_numpy(np.asarray(v)))
    opt_state_like.set_state(count, flat[1:1 + n], flat[1 + n:1 + 2 * n])
    return params_like, opt_state_like, step


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
