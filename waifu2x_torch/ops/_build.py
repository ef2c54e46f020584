"""Build the port's CUDA sources (waifu2x_torch/csrc/*.cu) with nvcc at first
use and load them with ctypes.

Each source has a plain C interface, so nvcc builds it in seconds without
PyTorch's headers. The library lands in waifu2x_torch/build/ (git-ignored)
under a name that carries a hash of the source, the headers beside it
(csrc/*.cuh) and the flags, so an edited source is rebuilt and a built one
is reused. Nothing here runs at import
time: the CPU tests import every module on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output with ptxas' register/spill report) for
# libraries this process built; chip_smoke.py prints both
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def load(*names: str) -> list[ctypes.CDLL]:
    """Build (where needed, all nvcc processes started together) and load
    the libraries for csrc/<name>.cu; raises if a build fails."""
    with _lock:
        todo = {}
        for name in names:
            so = _lib_path(name)
            if name in _libs or so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            todo[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (so, tmp, t0, proc) in todo.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = (time.perf_counter() - t0, out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)   # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return [_libs[name] for name in names]
