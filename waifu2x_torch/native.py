"""ctypes binding of the shared native host runtime (native/w2x_host.cpp).

The reference's host runtime is C++ (OpenCV codecs main.cpp:74,190, the
std::thread pool modelHandler.cpp:42-69). native/libw2x_host.so holds the
repo's equivalents: libpng/libjpeg codecs, the polyphase u8 interleave, a
threaded batch decoder and alpha flattening. Both packages load the same
library; this is the port's own binding of it, with the same argtypes and
functions as the JAX package's. If the library is missing it is built on
first use (`make -C native`); if that fails, or it does not load, every
function here returns None (or False) and the callers fall back
(waifu2x_torch/io.py, ops/s2d.d2s_host).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libw2x_host.so")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = None  # None=untried, False=unavailable
_u8p = ctypes.POINTER(ctypes.c_uint8)


class _BatchItem(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_char_p),
        ("data", _u8p),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("status", ctypes.c_int),
    ]


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_LIB_PATH)


def load():
    """The loaded CDLL, or None when the native runtime is unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        if not os.path.exists(_LIB_PATH) and not _build():
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib = False
            return None
        ip = ctypes.POINTER(ctypes.c_int)
        lib.w2x_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_u8p), ip, ip, ip, ctypes.c_int]
        lib.w2x_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_u8p), ip, ip, ip]
        lib.w2x_encode_png.argtypes = [
            ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.w2x_free.argtypes = [_u8p]
        lib.w2x_d2s_u8.argtypes = [_u8p, _u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
        lib.w2x_decode_batch.argtypes = [ctypes.POINTER(_BatchItem),
                                         ctypes.c_int, ctypes.c_int]
        lib.w2x_flatten_white.argtypes = [_u8p, _u8p, ctypes.c_int64]
        for fn in ("w2x_decode_png", "w2x_decode_jpeg", "w2x_encode_png",
                   "w2x_decode_batch"):
            getattr(lib, fn).restype = ctypes.c_int
        for fn in ("w2x_free", "w2x_d2s_u8", "w2x_flatten_white"):
            getattr(lib, fn).restype = None
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def _take(lib, ptr, h, w, c) -> np.ndarray:
    """Copy a native buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(h * w * c,)).reshape(
        h, w, c).copy()
    lib.w2x_free(ptr)
    return arr


def imread(path: str, keep_alpha: bool = False) -> np.ndarray | None:
    """Decode PNG/JPEG to u8 BGR (or BGRA with keep_alpha, where the file
    has alpha). None if the runtime is unavailable, the format is not PNG or
    JPEG, or the decoder fails (e.g. a CMYK JPEG): the caller falls back."""
    lib = load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        magic = f.read(4)
    out, w, h, c = _u8p(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if magic[:2] == b"\x89P":
        rc = lib.w2x_decode_png(path.encode(), ctypes.byref(out),
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c), int(keep_alpha))
    elif magic[:2] == b"\xff\xd8":
        if keep_alpha:
            return None  # JPEG has no alpha; signal "no alpha present"
        rc = lib.w2x_decode_jpeg(path.encode(), ctypes.byref(out),
                                 ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(c))
    else:
        return None
    if rc != 0:
        return None
    return _take(lib, out, h.value, w.value, c.value)


def imwrite_png(path: str, img: np.ndarray) -> bool:
    """Encode u8 BGR/BGRA to PNG. False if the runtime is unavailable."""
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    rc = lib.w2x_encode_png(path.encode(), img.ctypes.data_as(_u8p), w, h, c)
    if rc != 0:
        raise IOError(f"native PNG encode failed ({rc}): {path}")
    return True


def d2s_u8(src: np.ndarray) -> np.ndarray | None:
    """Native polyphase->raster interleave: u8 [..., h, w, 4c] -> u8
    [..., 2h, 2w, c]. None if unavailable."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.uint8)
    *lead, h, w, c4 = src.shape
    c = c4 // 4
    flat = src.reshape(-1, h, w, c4)
    out = np.empty((flat.shape[0], 2 * h, 2 * w, c), np.uint8)
    for i in range(flat.shape[0]):
        lib.w2x_d2s_u8(flat[i].ctypes.data_as(_u8p),
                       out[i].ctypes.data_as(_u8p), h, w, c)
    return out.reshape(*lead, 2 * h, 2 * w, c)


def decode_batch(paths: list[str], threads: int = 4):
    """Decode many images on the native thread pool. A list of u8 BGR
    arrays with None where the native decoder failed (the caller retries
    those), or None if the runtime is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    items = (_BatchItem * n)()
    enc = [p.encode() for p in paths]  # keep the path buffers alive
    for i, e in enumerate(enc):
        items[i].path = e
    lib.w2x_decode_batch(items, n, max(1, threads))
    return [_take(lib, it.data, it.h, it.w, it.channels)
            if it.status == 0 else None for it in items]


def flatten_white(bgra: np.ndarray) -> np.ndarray | None:
    """BGRA -> BGR composited on white (image_loader.lua:23-33)."""
    lib = load()
    if lib is None:
        return None
    bgra = np.ascontiguousarray(bgra, np.uint8)
    h, w, _ = bgra.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.w2x_flatten_white(bgra.ctypes.data_as(_u8p), out.ctypes.data_as(_u8p),
                          h * w)
    return out
