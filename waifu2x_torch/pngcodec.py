"""A PNG codec in numpy and the standard library's zlib: the last link of
the port's codec chain (io.py), for a host where the native runtime does
not load (no libpng, no libjpeg) and neither cv2 nor PIL is installed.

It reads 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA files with
any of the five row filters, and writes 8-bit RGB or RGBA with filter 0
(none) on every row. Channel order at the interface is BGR(A), as
cv::imread/imwrite and the native runtime have it: a gray file reads as
three equal channels, and alpha is dropped unless the caller keeps it.
Files outside that set raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(">I", crc)[0] != (
                zlib.crc32(kind + body) & 0xFFFFFFFF):
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter_slow(kind: int, cur: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4): each byte depends on the one decoded
    before it in the row, so the row is undone byte by byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> u8 [h, w, samples] in the file's order (gray, gray+A,
    RGB or RGBA)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace} (this codec reads "
                         f"8-bit non-interlaced gray, gray+alpha, RGB, RGBA)")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data, want "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, cur = int(raw[r, 0]), raw[r, 1:]
        if kind == 0:
            row = cur
        elif kind == 1:      # Sub: a running sum along the row, mod 256
            row = np.cumsum(cur.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:      # Up
            row = cur + prior
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_slow(kind, buf, prior.tobytes(), bpp)
            row = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"PNG: row {r} has filter type {kind}")
        out[r] = row
        prior = out[r]
    return out.reshape(h, w, bpp)


def read_bgr(path: str, keep_alpha: bool = False) -> np.ndarray:
    """A PNG file -> u8 BGR, or BGRA where keep_alpha is set and the file
    has alpha (w2x_decode_png's contract)."""
    with open(path, "rb") as f:
        px = decode(f.read())
    alpha = px[..., -1:] if px.shape[2] in (2, 4) else None
    color = px[..., :1].repeat(3, axis=2) if px.shape[2] <= 2 else (
        px[..., 2::-1])
    if keep_alpha and alpha is not None:
        return np.ascontiguousarray(np.concatenate([color, alpha], axis=2))
    return np.ascontiguousarray(color)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(bgr: np.ndarray, level: int = 6) -> bytes:
    """u8 BGR [h, w, 3] or BGRA [h, w, 4] -> PNG bytes (RGB / RGBA, filter
    0 on every row)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] not in (3, 4):
        raise ValueError(f"expected u8 BGR or BGRA, got {bgr.dtype} "
                         f"{bgr.shape}")
    h, w, c = bgr.shape
    order = [2, 1, 0, 3][:c]                      # BGR(A) -> RGB(A)
    rows = np.zeros((h, w * c + 1), np.uint8)     # column 0: filter type 0
    rows[:, 1:] = bgr[..., order].reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_bgr(path: str, bgr: np.ndarray) -> None:
    data = encode(np.ascontiguousarray(bgr))
    with open(path, "wb") as f:
        f.write(data)
