"""Host-side image I/O and output naming (reference C2, C3).

Decoding and encoding are host work; the reference used OpenCV for them
(cv::imread/imwrite, main.cpp:74, 190). Codec order, as in the JAX package,
with one last link:
  1. the shared native runtime (native/w2x_host.cpp through
     waifu2x_torch.native: libpng/libjpeg, BGR order, threaded batch
     decode);
  2. cv2, where installed (same codecs, same order);
  3. PIL, where installed;
  4. pngcodec.py, a PNG codec in numpy and zlib, for a host where the
     native runtime does not load (libpng and libjpeg missing) and neither
     cv2 nor PIL is installed. It reads and writes PNG only: there a JPEG
     cannot be read, and the error says so.
cv2 and PIL are imported only when the native runtime cannot handle a file,
so this module imports on a host that has neither. CODEC_CALLS counts each
read and write by the codec that did it.
"""

from __future__ import annotations

import collections
import os

import numpy as np

from waifu2x_torch import native, pngcodec

# (op, codec) -> calls: op "read" or "write"; codec "native", "cv2", "PIL"
# or "png" (pngcodec.py). A read through imread_batch_bgr counts one per
# file.
CODEC_CALLS: collections.Counter = collections.Counter()


def _cv2():
    """cv2, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    """PIL.Image, or None where it is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == pngcodec.SIGNATURE


def _read_fallback(path: str, keep_alpha: bool) -> "np.ndarray | None":
    """cv2, PIL, then pngcodec: u8 BGR, or with keep_alpha BGRA where the
    file has alpha and else None."""
    cv2 = _cv2()
    if cv2 is not None:
        CODEC_CALLS["read", "cv2"] += 1
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED if keep_alpha
                         else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"couldn't read image: {path}")
        if keep_alpha:
            return img if img.ndim == 3 and img.shape[2] == 4 else None
        return img
    Image = _pil_image()
    if Image is not None:
        CODEC_CALLS["read", "PIL"] += 1
        img = Image.open(path)
        if keep_alpha:
            if img.mode not in ("RGBA", "LA", "PA"):
                return None
            return np.asarray(img.convert("RGBA"))[:, :, [2, 1, 0, 3]].copy()
        return np.asarray(img.convert("RGB"))[:, :, ::-1].copy()
    if not _is_png(path):
        raise IOError(f"couldn't read image: {path}: this host reads PNG "
                      f"only (a JPEG needs the native runtime's libjpeg, "
                      f"cv2 or PIL, and none of them is available)")
    CODEC_CALLS["read", "png"] += 1
    img = pngcodec.read_bgr(path, keep_alpha)
    if keep_alpha:
        return img if img.shape[2] == 4 else None
    return img


def imread_bgr(path: str) -> np.ndarray:
    """Read an image as uint8 BGR (cv::imread IMREAD_COLOR semantics —
    drops alpha, 3 channels, BGR order; main.cpp:74)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"couldn't read image: {path}")
    img = native.imread(path)
    if img is not None:
        CODEC_CALLS["read", "native"] += 1
        return img
    return _read_fallback(path, keep_alpha=False)


def imread_bgra(path: str) -> np.ndarray | None:
    """Read with alpha kept where the file has one (for the opt-in alpha
    pipeline, appendix/hints-jp.md:76-81). uint8 BGRA, or None when the
    file has no alpha."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"couldn't read image: {path}")
    img = native.imread(path, keep_alpha=True)
    if img is not None:
        CODEC_CALLS["read", "native"] += 1
        return img if img.shape[2] == 4 else None
    return _read_fallback(path, keep_alpha=True)


def imread_batch_bgr(paths: list[str], jobs: int = 4) -> list[np.ndarray]:
    """Decode many images (the native thread pool where it loads — the
    host analogue of the reference's -j/nJob worker fan-out, main.cpp:79);
    files it cannot decode go through imread_bgr."""
    decoded = native.decode_batch(list(paths), threads=jobs)
    if decoded is None:
        decoded = [None] * len(paths)
    n_native = sum(r is not None for r in decoded)
    if n_native:
        CODEC_CALLS["read", "native"] += n_native
    return [r if r is not None else imread_bgr(p)
            for p, r in zip(paths, decoded)]


def flatten_white(bgra_u8: np.ndarray) -> np.ndarray:
    """Composite a uint8 BGRA image onto white -> uint8 BGR:
    c' = c*a + (1-a) on the unit scale, the original waifu2x loader's alpha
    handling (appendix/waifu2x-nocuda/lib/image_loader.lua:23-33). The
    native w2x_flatten_white where it loads, else the numpy twin; both
    round to nearest on the byte scale."""
    if bgra_u8.ndim != 3 or bgra_u8.shape[2] != 4:
        raise ValueError(f"expected BGRA, got shape {bgra_u8.shape}")
    out = native.flatten_white(bgra_u8)
    if out is not None:
        return out
    c = bgra_u8[:, :, :3].astype(np.uint32)
    a = bgra_u8[:, :, 3:4].astype(np.uint32)
    return ((c * a + 255 * (255 - a) + 127) // 255).astype(np.uint8)


def imwrite_bgr(path: str, img_bgr_u8: np.ndarray) -> None:
    """Write a uint8 BGR (or BGRA) image (cv::imwrite, main.cpp:190)."""
    png = path.lower().endswith(".png")
    if png and native.imwrite_png(path, img_bgr_u8):
        CODEC_CALLS["write", "native"] += 1
        return
    cv2 = _cv2()
    if cv2 is not None:
        CODEC_CALLS["write", "cv2"] += 1
        if not cv2.imwrite(path, img_bgr_u8):
            raise IOError(f"couldn't write image: {path}")
        return
    Image = _pil_image()
    if Image is not None:
        CODEC_CALLS["write", "PIL"] += 1
        if img_bgr_u8.shape[2] == 4:
            Image.fromarray(img_bgr_u8[:, :, [2, 1, 0, 3]], "RGBA").save(path)
        else:
            Image.fromarray(np.ascontiguousarray(img_bgr_u8[:, :, ::-1])
                            ).save(path)
        return
    if not png:
        raise IOError(f"couldn't write image: {path}: this host writes PNG "
                      f"only (no native runtime, cv2 or PIL)")
    CODEC_CALLS["write", "png"] += 1
    pngcodec.write_bgr(path, img_bgr_u8)


def _cpp_double_str(x: float) -> str:
    """std::to_string(double): fixed notation, 6 decimals (main.cpp:185)."""
    return f"{x:.6f}"


def auto_output_name(input_path: str, mode: str, noise_level: int,
                     scale_ratio: float) -> str:
    """Default output filename when -o is omitted, as main.cpp:173-189:
    strip from the LAST dot, then append "(mode)" ["(LevelN)"]
    ["(xR.RRRRRR)"] ".png"."""
    tail_dot = input_path.rfind(".")
    base = input_path[:tail_dot] if tail_dot != -1 else input_path
    name = f"{base}({mode})"
    if "noise" in mode:
        name += f"(Level{noise_level})"
    if "scale" in mode:
        name += f"(x{_cpp_double_str(scale_ratio)})"
    return name + ".png"


def default_model_dir() -> str:
    """The repo's models/ (the reference's default `models` flag value,
    main.cpp:56); where there is none (an installed package), a per-user
    cache dir that ensure_default_models can fill."""
    repo_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models")
    if os.path.isdir(repo_dir):
        return repo_dir
    cache_root = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache_root, "waifu2x_torch", "models")
