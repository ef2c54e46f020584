"""End-to-end conversion pipeline, scale path (reference main.cpp:82-169).

Per image:
  u8 BGR -> f32/255 -> (OpenCV-quirk) YUV
         -> [2x-scale loop: nearest-2x Y -> conv stack; cubic-2x U/V]
            x ceil(log2 r)
         -> [final linear shrink if r is not the reached power of 2]
         -> YUV -> f32*255 saturate-cast u8 BGR

The kernel path runs each 2x step on the low-res grid: the conv stack
(ops/stack.py, a hand-written CUDA kernel) emits the converted luma in s2d
layout, a dense PyTorch tail adds the polyphase bicubic U/V and the u8 BGR
conversion, and the host interleaves the u8 result (d2s_host_cmajor).
Images below SMALL_IMG_PX take the f32 non-kernel path (F.conv2d, TF32 off),
as the JAX package routes them.

Entry points run on the CUDA card unless the caller passes device="cpu";
with no card and no CPU request they raise. The noise and noise_scale modes
belong to a later slice and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from waifu2x_torch.config import Config
from waifu2x_torch.models.srcnn import SRCNN, WAIFU2X_7LAYER, validate_params
from waifu2x_torch.models.weights import load_model_json, model_file_for
from waifu2x_torch.ops import color
from waifu2x_torch.ops.color import (
    bgr_to_yuv,
    saturate_cast_u8,
    u8_to_unit_f32,
    yuv_to_bgr,
)
from waifu2x_torch.ops.resize import (
    CUBIC,
    LINEAR,
    NEAREST,
    resize,
    resize2x_phases,
)
from waifu2x_torch.ops.s2d import d2s, d2s_host_cmajor
from waifu2x_torch.ops.stack import prep_params, stack_scale
from waifu2x_torch.utils.logging import get_logger

log = get_logger("pipeline")

NOISE_TODO = ("the noise and noise_scale modes need the noise stack, "
              "ROADMAP.md queue A item 9 (the noise slice)")


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA request with no card raises
    (the port never carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def scale_plan(scale_ratio: float) -> tuple[int, float]:
    """(number of 2x iterations, final shrink ratio or 0.0) — replicates
    main.cpp:107-114 including the int-vs-double comparison quirk:
    shrink is skipped only when int(scale_ratio) == 2**iters exactly."""
    if scale_ratio <= 0:
        raise ValueError("scale_ratio must be positive")
    iters = max(0, math.ceil(math.log2(scale_ratio)))
    shrink = 0.0
    if int(scale_ratio) != 2 ** iters:
        shrink = scale_ratio / (2.0 ** iters)
    return iters, shrink


# ---------------------------------------------------------------------------
# Non-kernel path: F.conv2d stack on the full-res plane (TF32 off).
# ---------------------------------------------------------------------------

def _convert_y(y: torch.Tensor, model: SRCNN, cfg: Config) -> torch.Tensor:
    """Run the conv stack on luma planes [N, H, W], monolithic (the JAX
    package's block tiler is bit-equal to monolithic and is a later
    slice). compute_dtype="bfloat16" runs it in bf16, as the JAX package
    does on this path."""
    in_dtype = y.dtype
    if cfg.compute_dtype == "bfloat16":
        y = y.to(torch.bfloat16)
    return model.convert_plane(y).to(in_dtype)


def scale2x_batch(yuv: torch.Tensor, model: SRCNN,
                  cfg: Config) -> torch.Tensor:
    """One 2x iteration (main.cpp:126-156) on f32 YUV [N, H, W, 3] ->
    [N, 2H, 2W, 3]: CNN input Y from a NEAREST 2x resize, U/V (and the
    container) from a CUBIC 2x resize."""
    n, h, w, _ = yuv.shape
    dsize = (h * 2, w * 2)
    y_in = resize(yuv[..., 0], dsize, NEAREST, h_axis=1)
    out = resize(yuv, dsize, CUBIC, h_axis=1)
    out[..., 0] = _convert_y(y_in, model, cfg)
    return out


def _scale_step(yuv: torch.Tensor, model: SRCNN, cfg: Config) -> torch.Tensor:
    return scale2x_batch(yuv[None], model, cfg)[0]


def _shrink(yuv: torch.Tensor, dsize: tuple[int, int]) -> torch.Tensor:
    return resize(yuv, dsize, LINEAR)


# ---------------------------------------------------------------------------
# Kernel path: the whole 2x step on the low-res grid in s2d layout.
# ---------------------------------------------------------------------------

def _kernel_dtype(cfg: Config) -> torch.dtype:
    """Kernel storage dtype: 'auto' means bf16 activations with f32
    accumulation; 'float32' is honoured."""
    return torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16


@dataclasses.dataclass(frozen=True)
class FastStack:
    """Device-ready conv-stack kernel weights for one model."""

    sp: tuple
    dtype: torch.dtype

    @classmethod
    def build(cls, params, scale_input: bool = True, dtype=torch.bfloat16,
              device="cuda") -> "FastStack":
        """Raises ValueError for any architecture other than the flagship
        7-layer spec: the kernel bakes its widths into its template
        instances. Other architectures run on the non-kernel path."""
        spec = validate_params(params)
        if spec != WAIFU2X_7LAYER:
            raise ValueError(
                f"the conv-stack kernel supports only the flagship 7-layer "
                f"architecture (widths 1/32/32/64/64/128/128/1, 3x3); got "
                f"{[l.cout for l in spec.layers]} — use the non-kernel path")
        if not scale_input:
            raise NotImplementedError(NOISE_TODO)
        return cls(prep_params(params, dtype, resolve_device(device)), dtype)

    def scale(self, ylow: torch.Tensor) -> torch.Tensor:
        """Low-res luma [N, hl, wl] -> converted Y in s2d layout
        [N, hl, wl, 4] (storage dtype)."""
        return stack_scale(ylow.to(self.dtype).contiguous(), self.sp)


def scale2x_yuv_s2d(yuv: torch.Tensor, fast: FastStack) -> torch.Tensor:
    """One 2x iteration on the low-res grid: f32 YUV [N, h, w, 3] -> f32
    YUV in polyphase layout [N, h, w, 4, 3] (phase A*2+B = full-res pixel
    (2i+A, 2j+B)): Y through the conv stack, U/V through polyphase bicubic."""
    y_s2d = fast.scale(yuv[..., 0]).to(yuv.dtype)            # [N, h, w, 4]
    uv = resize2x_phases(yuv[..., 1:3], CUBIC, h_axis=1)     # [N, h, w, 2, 4]
    uv = uv.transpose(-1, -2)                                # [N, h, w, 4, 2]
    return torch.cat([y_s2d[..., None], uv], dim=-1)


def _combine_u8_cmajor(y2, u2, v2, n, h, w):
    """Flat [n, h, w*4] Y/U/V phase planes -> uint8 BGR in CHANNEL-MAJOR
    polyphase layout [n, h, w, 16] (lane c*4+phase, lanes 12:16 zero).
    Same math as yuv_to_bgr / saturate_cast_u8, in the same f32 order."""
    inv, off = color._INV, color._INV_OFF
    chans = []
    for c in range(3):
        val = (y2 * float(inv[c, 0]) + u2 * float(inv[c, 1])
               + v2 * float(inv[c, 2]) + float(off[c])) * 255.0
        chans.append(torch.clamp(torch.round(val), 0, 255)
                     .to(torch.uint8).reshape(n, h, w, 4))
    chans.append(torch.zeros_like(chans[0]))
    return torch.cat(chans, dim=-1)                          # [n, h, w, 16]


def _tail_u8_cmajor(y_s2d: torch.Tensor, yuv: torch.Tensor) -> torch.Tensor:
    """Dense u8/BGR scale tail: converted-Y s2d [N,h,w,4] + f32 YUV
    [N,h,w,3] -> u8 BGR cmajor [N,h,w,16] (interleave with
    d2s_host_cmajor)."""
    n, h, w, _ = yuv.shape
    ph = resize2x_phases(yuv[..., 1:3], CUBIC, h_axis=1)     # [n,h,w,2,4]
    y2 = y_s2d[:, :h, :w, :].to(torch.float32).reshape(n, h, w * 4)
    u2 = ph[..., 0, :].reshape(n, h, w * 4)
    v2 = ph[..., 1, :].reshape(n, h, w * 4)
    return _combine_u8_cmajor(y2, u2, v2, n, h, w)


def _fused_step(yuv: torch.Tensor, fast: FastStack,
                y: "torch.Tensor | None" = None) -> torch.Tensor:
    """Conv-stack kernel + dense tail. `y` overrides the luma plane
    (chained steps pass a denoised plane; the tail reads only yuv's U/V)."""
    if y is None:
        y = yuv[..., 0]
    return _tail_u8_cmajor(fast.scale(y), yuv)


BAND_ROWS = 1152     # low-res rows per banded dispatch (large frames)
BAND_PX = 2 * 1152 * 3840   # low-res px per dispatch, batch included: rows
#                      alone don't bound device memory, so
#                      scale2x_batch_u8_fused caps rows at
#                      BAND_PX / (batch * width)
_BAND_HALO = 4       # one-sided receptive radius of the whole 2x step


def _bands(h: int, band_rows: int):
    """Row bands of a tall low-res frame: (slice start, size, first output
    row, output rows). Bands overlap by _BAND_HALO rows on each side, so
    every band's kept rows are exact; all interior bands share one size."""
    k = _BAND_HALO
    n_bands = -(-h // band_rows)
    rows = -(-h // n_bands)          # even bands: no oversized tail slice
    size = min(h, rows + 2 * k)
    for b0 in range(0, h, rows):
        s = min(max(0, b0 - k), h - size)
        yield s, size, b0 - s, min(rows, h - b0)


def _band_rows(band_rows: int, n: int, w: int) -> int:
    # the per-dispatch volume cap counts the batch too (see BAND_PX)
    return max(64, min(band_rows, BAND_PX // max(1, n * w)))


def scale2x_batch_u8_fused(yuv: torch.Tensor, fast: FastStack,
                           band_rows: int = BAND_ROWS,
                           y: "torch.Tensor | None" = None) -> torch.Tensor:
    """Throughput 2x step: f32 YUV [N, h, w, 3] -> uint8 BGR in
    CHANNEL-MAJOR polyphase layout [N, h, w, 16] (lane c*4 + phase, lanes
    12:16 zero). Interleave with d2s_host_cmajor.

    Frames taller than the band limit run in row bands with a
    _BAND_HALO-row overlap each side; band outputs are exact (the step's
    one-sided receptive radius is 4 low-res rows, true edges keep
    replicate semantics)."""
    n, h, w, _ = yuv.shape
    band_rows = _band_rows(band_rows, n, w)
    if h <= band_rows:
        return _fused_step(yuv, fast, y=y)
    outs = []
    for s, size, lo, nrows in _bands(h, band_rows):
        out = _fused_step(yuv[:, s:s + size], fast,
                          y=None if y is None else y[:, s:s + size])
        outs.append(out[:, lo:lo + nrows])
    return torch.cat(outs, dim=1)


def scale2x_batch_fast(yuv: torch.Tensor, fast: FastStack,
                       band_rows: int = BAND_ROWS) -> torch.Tensor:
    """Kernel-path twin of scale2x_batch: f32 YUV [N,h,w,3] -> [N,2h,2w,3]
    (device-side interleave; used when further scale iterations follow),
    under the same BAND_PX per-dispatch cap as the u8 path."""
    n, h, w, _ = yuv.shape
    band_rows = _band_rows(band_rows, n, w)
    if h <= band_rows:
        s2d_out = scale2x_yuv_s2d(yuv, fast)
    else:
        s2d_out = torch.cat(
            [scale2x_yuv_s2d(yuv[:, s:s + size], fast)[:, lo:lo + nrows]
             for s, size, lo, nrows in _bands(h, band_rows)], dim=1)
    return d2s(s2d_out.reshape(n, h, w, 12))


def _build_fast(params, cfg: Config,
                device: torch.device) -> "FastStack | None":
    """Resolve cfg.use_pallas to a FastStack or None (non-kernel path).
    "auto" enables the kernel on a CUDA device; True anywhere (its plain
    version on the CPU). An architecture the kernel does not take runs on
    the non-kernel path, with a logged warning."""
    want = cfg.use_pallas
    if want is False or (want == "auto" and device.type != "cuda"):
        return None
    if validate_params(params) != WAIFU2X_7LAYER:
        log.warning("conv-stack kernel unavailable (architecture is not "
                    "the flagship 7-layer model); using the non-kernel path")
        return None
    return FastStack.build(params, True, dtype=_kernel_dtype(cfg),
                           device=device)


def _to_yuv(bgr_u8: torch.Tensor) -> torch.Tensor:
    return bgr_to_yuv(u8_to_unit_f32(bgr_u8))


def _to_bgr_u8(yuv: torch.Tensor) -> torch.Tensor:
    return saturate_cast_u8(yuv_to_bgr(yuv))


SMALL_IMG_PX = 96 * 1024
# Below ~0.1 MP the bf16 kernel's output is edge-dominated (the one-sided
# replicate halo's bf16 rounding concentrates at borders), so under
# use_pallas="auto" such images take the f32 non-kernel path, as the JAX
# package routes them.


@dataclasses.dataclass
class Converter:
    """Loaded-model pipeline front end for mode="scale" (model resolution
    main.cpp:82-121 + the phase drivers)."""

    cfg: Config
    device: torch.device
    scale_model: "SRCNN | None" = None
    fast_scale: "FastStack | None" = None

    def _fast_ok(self, fast: "FastStack | None", px: int) -> bool:
        """Use the kernel for this plane? 'auto' keeps tiny images on the
        non-kernel path for fidelity (SMALL_IMG_PX); use_pallas=True
        honours the user's choice at any size. `px` is the low-res input's
        pixel count."""
        if fast is None:
            return False
        return self.cfg.use_pallas is True or px >= SMALL_IMG_PX

    @classmethod
    def from_config(cls, cfg: Config, device="cuda") -> "Converter":
        if cfg.mode != "scale":
            raise NotImplementedError(NOISE_TODO)
        dev = resolve_device(device)
        params = load_model_json(model_file_for(cfg.model_dir, False))
        return cls(cfg, dev, SRCNN.from_params(params).to(dev),
                   _build_fast(params, cfg, dev))

    def _apply_scale_iter(self, yuv: torch.Tensor) -> torch.Tensor:
        if self._fast_ok(self.fast_scale, yuv.shape[0] * yuv.shape[1]):
            return scale2x_batch_fast(yuv[None], self.fast_scale)[0]
        return _scale_step(yuv, self.scale_model, self.cfg)

    def process_yuv(self, yuv: torch.Tensor) -> torch.Tensor:
        if self.scale_model is not None:
            iters, shrink = scale_plan(self.cfg.scale_ratio)
            for _ in range(iters):
                yuv = self._apply_scale_iter(yuv)
            if shrink != 0.0:
                h, w, _ = yuv.shape
                # int truncation as in main.cpp:160-165
                yuv = _shrink(yuv, (int(h * shrink), int(w * shrink)))
        return yuv

    def _final_fast_u8(self, yuv: torch.Tensor) -> "np.ndarray | None":
        """The flagship single-image path: when the conversion ENDS with a
        kernel-path 2x iteration (no shrink after it), run that iteration
        through scale2x_batch_u8_fused and interleave the u8 result on the
        host. Returns the u8 BGR image, or None when the conversion does
        not end that way (shrink step, non-kernel path, tiny image)."""
        if self.scale_model is None:
            return None
        iters, shrink = scale_plan(self.cfg.scale_ratio)
        if iters < 1 or shrink != 0.0:
            return None
        h, w = yuv.shape[0], yuv.shape[1]
        hN, wN = h << (iters - 1), w << (iters - 1)  # last iteration input
        if not self._fast_ok(self.fast_scale, hN * wN):
            return None
        for _ in range(iters - 1):
            yuv = self._apply_scale_iter(yuv)
        out = scale2x_batch_u8_fused(yuv[None], self.fast_scale)
        return d2s_host_cmajor(out.cpu().numpy())[0]

    def process_bgr_u8(self, bgr_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR in, uint8 BGR out — the whole main.cpp math path."""
        img = torch.from_numpy(np.ascontiguousarray(bgr_u8)).to(self.device)
        yuv = _to_yuv(img)
        out = self._final_fast_u8(yuv)
        if out is not None:
            return out
        return _to_bgr_u8(self.process_yuv(yuv)).cpu().numpy()

    def process_alpha(self, alpha_u8: np.ndarray) -> np.ndarray:
        """Opt-in alpha channel handling: plain bicubic resample of A at the
        final geometry (appendix/hints-jp.md:76-81; the reference CLI
        itself drops alpha)."""
        a = u8_to_unit_f32(torch.from_numpy(np.ascontiguousarray(alpha_u8))
                           .to(self.device))
        if self.scale_model is not None:
            iters, shrink = scale_plan(self.cfg.scale_ratio)
            for _ in range(iters):
                a = resize(a, (a.shape[0] * 2, a.shape[1] * 2), CUBIC)
            if shrink != 0.0:
                a = resize(a, (int(a.shape[0] * shrink),
                               int(a.shape[1] * shrink)), LINEAR)
        return saturate_cast_u8(a).cpu().numpy()


def convert_image(bgr_u8: np.ndarray, cfg: Config, noise_params=None,
                  scale_params=None, device="cuda") -> np.ndarray:
    """One-shot functional API (loads nothing; params passed explicitly as
    HWIO tensors). Only mode="scale" is ported; `noise_params` is ignored
    there, as in the JAX package."""
    if cfg.mode != "scale":
        raise NotImplementedError(NOISE_TODO)
    dev = resolve_device(device)
    model = fast = None
    if scale_params is not None:
        model = SRCNN.from_params(scale_params).to(dev)
        fast = _build_fast(scale_params, cfg, dev)
    return Converter(cfg, dev, model, fast).process_bgr_u8(bgr_u8)
