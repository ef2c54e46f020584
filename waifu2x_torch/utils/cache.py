"""Where the port keeps its built kernels: the counterpart of the JAX
package's persistent compilation cache (utils/cache.py there).

The first call of a process builds each CUDA source with nvcc (seconds a
file) into ops/_build.BUILD_DIR, under a name that carries a hash of the
source, its headers and the flags; a later process that finds the file
loads it and builds nothing. A directory shared between checkouts or runs
therefore stays correct. Call enable_compilation_cache before the first
kernel is loaded (before Converter.from_config): libraries already loaded
stay where they were built."""

from __future__ import annotations

import os
from pathlib import Path

from waifu2x_torch.ops import _build


def enable_compilation_cache(path: str | None = None) -> None:
    """Build and load kernels in `path`, else in $W2X_BUILD_DIR; with
    neither set, leave ops/_build.BUILD_DIR (waifu2x_torch/build/, which
    git ignores) as it is."""
    cache_dir = path or os.environ.get("W2X_BUILD_DIR")
    if cache_dir:
        _build.BUILD_DIR = Path(cache_dir).expanduser().resolve()
