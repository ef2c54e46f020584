"""Image resize — OpenCV semantics (INTER_NEAREST / INTER_LINEAR /
INTER_CUBIC) as a separable gather + weighted sum.

The reference uses exactly three interpolation modes:
  * INTER_NEAREST 2x  — CNN input for each doubling step (main.cpp:136)
  * INTER_CUBIC 2x    — U/V channels + output container     (main.cpp:145)
  * INTER_LINEAR      — final non-power-of-2 shrink         (main.cpp:166)

OpenCV's coordinate mapping (resize.cpp):
  nearest: src_x = floor(dst_x * scale),             scale = src/dst
  linear/cubic: src_x = (dst_x + 0.5) * scale - 0.5, 4 (cubic) or 2 taps,
  sample indices clamped to the valid range (replicate-border semantics),
  cubic kernel is the a = -0.75 Keys filter.

Tap indices and weights are planned on the host in numpy (the same plan as
the JAX package); the gather and the weighted sum run on the tensor's
device. Each axis is resampled independently, vertical first.
"""

from __future__ import annotations

import numpy as np
import torch

NEAREST = "nearest"
LINEAR = "linear"
CUBIC = "cubic"


def _cubic_weights(frac: np.ndarray) -> np.ndarray:
    """OpenCV interpolateCubic: Keys bicubic with A=-0.75; frac in [0,1);
    returns 4 taps for samples at offsets (-1, 0, 1, 2) from the base."""
    A = np.float32(-0.75)
    x = np.asarray(frac).astype(np.float32)
    w = np.empty(x.shape + (4,), np.float32)
    w[..., 0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    w[..., 1] = ((A + 2) * x - (A + 3)) * x * x + 1
    w[..., 2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    w[..., 3] = 1.0 - w[..., 0] - w[..., 1] - w[..., 2]
    return w


def _axis_plan(dst: int, src: int, interpolation: str):
    """Host-side tap plan for one axis -> (indices [dst, taps] int64,
    weights [dst, taps] f32)."""
    scale = src / dst
    dx = np.arange(dst, dtype=np.float64)
    if interpolation == NEAREST:
        # OpenCV INTER_NEAREST: floor(dst_x * scale), clamped
        idx = np.clip(np.floor(dx * scale).astype(np.int64), 0, src - 1)
        return idx[:, None], np.ones((dst, 1), np.float32)
    fx = (dx + 0.5) * scale - 0.5
    base = np.floor(fx).astype(np.int64)
    frac = (fx - base).astype(np.float32)
    if interpolation == LINEAR:
        offs = np.array([0, 1])
        w = np.stack([1.0 - frac, frac], axis=-1).astype(np.float32)
    elif interpolation == CUBIC:
        offs = np.array([-1, 0, 1, 2])
        w = _cubic_weights(frac)
    else:
        raise ValueError(f"unknown interpolation: {interpolation!r}")
    idx = np.clip(base[:, None] + offs[None, :], 0, src - 1)
    return idx, w


def _resample_axis(img: torch.Tensor, axis: int, idx: np.ndarray,
                   w: np.ndarray) -> torch.Tensor:
    taps = idx.shape[1]
    index = torch.from_numpy(np.ascontiguousarray(idx.T)).to(img.device)
    if taps == 1:
        return img.index_select(axis, index[0])
    shape = [1] * img.dim()
    shape[axis] = idx.shape[0]
    weights = torch.from_numpy(np.ascontiguousarray(w.T)).to(img.device,
                                                               img.dtype)
    acc = None
    for t in range(taps):
        term = img.index_select(axis, index[t]) * weights[t].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize(img: torch.Tensor, dsize: tuple[int, int],
           interpolation: str = LINEAR, h_axis: int = 0) -> torch.Tensor:
    """Resize `img` so (axis h_axis, h_axis+1) becomes dsize=(H, W).

    Matches cv::resize(img, (W, H), interpolation) for float32 inputs; the
    2x-nearest / 2x-cubic / arbitrary-linear calls of the reference pipeline
    (main.cpp:136, 145, 166) all route through here.
    """
    dh, dw = dsize
    sh, sw = img.shape[h_axis], img.shape[h_axis + 1]
    if (dh, dw) == (sh, sw):
        return img
    if dh != sh:
        idx, w = _axis_plan(dh, sh, interpolation)
        img = _resample_axis(img, h_axis, idx, w)
    if dw != sw:
        idx, w = _axis_plan(dw, sw, interpolation)
        img = _resample_axis(img, h_axis + 1, idx, w)
    return img


def _phase_taps(interpolation: str):
    """Static per-parity stencils of the 2x upsample: (offsets, w[2, taps]).
    Output x=2j+B samples src at j + (B+0.5)/2 - 0.5, i.e. frac 0.75 (B=0,
    base j-1) / 0.25 (B=1, base j) — fixed 4-tap (cubic) or 2-tap (linear)
    stencils."""
    if interpolation == CUBIC:
        offs = np.array([-2, -1, 0, 1])   # phase-0 taps rel. to j
        w = np.stack([_cubic_weights(np.float32(0.75)),
                      _cubic_weights(np.float32(0.25))])
        return offs, w                    # phase-1 taps = offs + 1
    if interpolation == LINEAR:
        offs = np.array([-1, 0])
        w = np.array([[0.25, 0.75], [0.75, 0.25]], np.float32)
        return offs, w
    raise ValueError(f"unsupported 2x-phase interpolation: {interpolation!r}")


def _stencil_axis(img: torch.Tensor, axis: int, offs, w) -> torch.Tensor:
    """Apply a 1-D stencil along `axis` with replicate borders: output j =
    sum_t w[t] * img[clamp(j + offs[t])]."""
    n = img.shape[axis]
    j = torch.arange(n, device=img.device)
    acc = None
    for t in range(len(offs)):
        src = torch.clamp(j + int(offs[t]), 0, n - 1)
        term = img.index_select(axis, src) * float(w[t])
        acc = term if acc is None else acc + term
    return acc


def resize2x_phases(img: torch.Tensor, interpolation: str = CUBIC,
                    h_axis: int = 0) -> torch.Tensor:
    """Polyphase 2x upsample: same arithmetic as resize(img, (2H, 2W)) but
    emitting the four parity phases as a trailing axis instead of an
    interleaved full-res image (the s2d layout the kernel path runs in).

    img [..., H, W, C...] -> [..., H, W, C..., 4] where phase index A*2+B
    equals full-res pixel (2i+A, 2j+B); vertical first.
    """
    offs, w = _phase_taps(interpolation)
    out = []
    for A in (0, 1):
        r = _stencil_axis(img, h_axis, offs + A, w[A])
        for B in (0, 1):
            out.append(_stencil_axis(r, h_axis + 1, offs + B, w[B]))
    return torch.stack(out, dim=-1)
