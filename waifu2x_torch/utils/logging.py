"""Structured logging — replaces the reference's bare std::cout progress
lines (convertRoutine.cpp:67,133; main.cpp:123-130)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s w2x[%(name)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger("waifu2x_torch")
    root.addHandler(handler)
    root.setLevel(os.environ.get("W2X_LOG", "INFO").upper())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"waifu2x_torch.{name}")
