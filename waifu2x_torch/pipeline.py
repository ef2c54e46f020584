"""End-to-end conversion pipeline (reference main.cpp:82-169).

Per image:
  u8 BGR -> f32/255 -> (OpenCV-quirk) YUV -> [noise stack on Y]
         -> [2x-scale loop: nearest-2x Y -> conv stack; cubic-2x U/V]
            x ceil(log2 r)
         -> [final linear shrink if r is not the reached power of 2]
         -> YUV -> f32*255 saturate-cast u8 BGR

The kernel path runs both stacks through one hand-written CUDA kernel
(ops/stack.py): the noise stack on the full-res plane, each 2x step's stack
on the low-res grid. Both emit the converted luma in s2d layout; a dense
PyTorch tail adds U/V (the polyphase bicubic of a scale step, the input's
own phases for a noise step) and the u8 BGR conversion, and the host
interleaves the u8 result (d2s_host_cmajor). W2X_TAIL=kernel moves the
scale step's tail into the kernel's last layer, and W2X_YDENSE=1 has that
layer store Y phase-chunked (see FUSED_TAIL and YDENSE below). W2X_L6_I8=1
and W2X_L6_WINO=1 run layer 6 of every stack here, scale and noise, as int8
or as Winograd F(2x2, 3x3): they act inside ops/stack.py (L6_I8, L6_WINO,
read when that module is imported), so FastStack and every step below follow
them with no argument of their own, as in the JAX package. Images below
SMALL_IMG_PX take the f32 non-kernel path (F.conv2d, TF32 off), as the JAX
package routes them. On that path one image's plane larger than 1.5
blocks (block_size squared) runs in batched halo tiles (parallel/tiles.py),
under the JAX package's rule.

Entry points run on the CUDA card unless the caller passes device="cpu";
with no card and no CPU request they raise.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_torch.config import Config
from waifu2x_torch.models import cunet
from waifu2x_torch.models.srcnn import SRCNN, WAIFU2X_7LAYER, validate_params
from waifu2x_torch.models.weights import load_model_json, model_file_for
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
from waifu2x_torch.ops.stack import (
    combine_u8_cmajor,
    dense_to_s2d,
    prep_params,
    stack_noise,
    stack_noise_s2d,
    stack_scale,
    stack_scale_dense,
    stack_scale_fused_u8,
)
from waifu2x_torch.ops.unet import CunetModel, upcunet_tiles_u8
from waifu2x_torch.parallel.mesh import local_devices
from waifu2x_torch.parallel.tiles import plan_tiles, tiled_convert
from waifu2x_torch.utils import trace
from waifu2x_torch.utils.logging import get_logger

log = get_logger("pipeline")


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

def _convert_y(y: torch.Tensor, model: SRCNN, cfg: Config,
               single: bool = False) -> torch.Tensor:
    """Run the conv stack on luma planes [N, H, W]. `single` says the
    planes are one image's ([1, H, W], from _noise_phase or _scale_step):
    those tile by the reference's rule W*H > blockW*blockH*3/2
    (convertRoutine.cpp:25-26) into cfg.tile_size tiles, cfg.batch_tiles at
    a time (parallel/tiles.py), as the JAX package tiles its 2-D planes;
    batches (noise_batch, scale2x_batch) run monolithic, as there.
    compute_dtype="bfloat16" runs the stack in bf16, as the JAX package
    does on this path."""
    in_dtype = y.dtype
    if cfg.compute_dtype == "bfloat16":
        y = y.to(torch.bfloat16)
    h, w = y.shape[-2:]
    bs = cfg.block_size
    if single and bs > 0 and h * w > bs * bs * 3 // 2:
        plan = plan_tiles(h, w, cfg.tile_size, model.spec.offset)
        out = tiled_convert(y[0], model, plan, cfg.batch_tiles)[None]
    else:
        out = model.convert_plane(y)
    return out.to(in_dtype)


def _with_y(yuv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A copy of YUV [..., 3] with its Y plane replaced by y."""
    out = yuv.clone()
    out[..., 0] = y
    return out


def noise_batch(yuv: torch.Tensor, model: SRCNN,
                cfg: Config) -> torch.Tensor:
    """Batched denoise pass: f32 YUV [N, H, W, 3] -> same shape, Y through
    the noise model (main.cpp denoises Y only)."""
    return _with_y(yuv, _convert_y(yuv[..., 0], model, cfg))


def _noise_phase(yuv: torch.Tensor, model: SRCNN,
                 cfg: Config) -> torch.Tensor:
    return _with_y(yuv, _convert_y(yuv[None, ..., 0], model, cfg,
                                   single=True)[0])


def _scale2x(yuv: torch.Tensor, model: SRCNN, cfg: Config,
             single: bool) -> torch.Tensor:
    n, h, w, _ = yuv.shape
    dsize = (h * 2, w * 2)
    y_in = resize(yuv[..., 0], dsize, NEAREST, h_axis=1)
    out = resize(yuv, dsize, CUBIC, h_axis=1)
    out[..., 0] = _convert_y(y_in, model, cfg, single)
    return out


def scale2x_batch(yuv: torch.Tensor, model: SRCNN,
                  cfg: Config) -> torch.Tensor:
    """One 2x iteration (main.cpp:126-156) on f32 YUV [N, H, W, 3] ->
    [N, 2H, 2W, 3]: CNN input Y from a NEAREST 2x resize, U/V (and the
    container) from a CUBIC 2x resize."""
    return _scale2x(yuv, model, cfg, single=False)


def _scale_step(yuv: torch.Tensor, model: SRCNN, cfg: Config) -> torch.Tensor:
    return _scale2x(yuv[None], model, cfg, single=True)[0]


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
    """Device-ready conv-stack kernel weights for one model (with layer 6's
    int8 and Winograd forms, which ops.stack's L6_I8 / L6_WINO select)."""

    sp: tuple
    dtype: torch.dtype

    @classmethod
    def build(cls, params, scale_input: bool = True, dtype=torch.bfloat16,
              device="cuda") -> "FastStack":
        """Raises ValueError for any architecture other than the flagship
        7-layer spec: the kernel bakes its widths into its template
        instances. Other architectures run on the non-kernel path.

        `scale_input` says which stack the weights are for, as in the JAX
        package. There it selects the layer-1 packing; the port's layout
        ([cin, 9, cout]) is the same for both stacks, and the method called
        (scale, noise, noise_s2d) selects the kernel's input mode."""
        spec = validate_params(params)
        if spec != WAIFU2X_7LAYER:
            raise ValueError(
                f"the conv-stack kernel supports only the flagship 7-layer "
                f"architecture (widths 1/32/32/64/64/128/128/1, 3x3); got "
                f"{[l.cout for l in spec.layers]} — use the non-kernel path")
        with trace.span("w2x.setup.prep", dtype=dtype):
            return cls(prep_params(params, dtype, resolve_device(device)),
                       dtype)

    def scale(self, ylow: torch.Tensor) -> torch.Tensor:
        """Low-res luma [N, hl, wl] -> converted Y in s2d layout
        [N, hl, wl, 4] (storage dtype)."""
        return stack_scale(ylow.to(self.dtype).contiguous(), self.sp)

    def scale_dense(self, ylow: torch.Tensor) -> "tuple[torch.Tensor, int]":
        """Low-res luma [N, hl, wl] -> (converted Y in the phase-chunked
        dense layout [N, hl, nx*4*tc] (storage dtype), tc); un-chunk with
        ops.stack.dense_to_s2d."""
        return stack_scale_dense(ylow.to(self.dtype).contiguous(), self.sp)

    def scale_fused_u8(self, ylow: torch.Tensor,
                       uvp: torch.Tensor) -> torch.Tensor:
        """Low-res luma [N, hl, wl] + polyphase U/V [N, hl, wl, 8] f32
        (_uv_phases_cmajor) -> u8 BGR cmajor [N, hl, wl, 16]: the whole 2x
        step, its tail inside the kernel's last layer."""
        return stack_scale_fused_u8(ylow.to(self.dtype).contiguous(),
                                    uvp.contiguous(), self.sp)

    def noise(self, y: torch.Tensor) -> torch.Tensor:
        """Full-res luma [N, h, w], any size -> denoised [N, h, w] (storage
        dtype)."""
        return stack_noise(y.to(self.dtype).contiguous(), self.sp)

    def noise_s2d(self, y: torch.Tensor) -> torch.Tensor:
        """Full-res luma [N, h, w], h and w even -> denoised Y in s2d layout
        [N, h/2, w/2, 4] (storage dtype). The JAX package's method also
        takes crop=False, which returns its tile-grid padding; the port's
        kernel pads to no grid, so it has no such argument."""
        return stack_noise_s2d(y.to(self.dtype).contiguous(), self.sp)


def scale2x_yuv_s2d(yuv: torch.Tensor, fast: FastStack) -> torch.Tensor:
    """One 2x iteration on the low-res grid: f32 YUV [N, h, w, 3] -> f32
    YUV in polyphase layout [N, h, w, 4, 3] (phase A*2+B = full-res pixel
    (2i+A, 2j+B)): Y through the conv stack, U/V through polyphase bicubic."""
    y_s2d = fast.scale(yuv[..., 0]).to(yuv.dtype)            # [N, h, w, 4]
    uv = resize2x_phases(yuv[..., 1:3], CUBIC, h_axis=1)     # [N, h, w, 2, 4]
    uv = uv.transpose(-1, -2)                                # [N, h, w, 4, 2]
    return torch.cat([y_s2d[..., None], uv], dim=-1)


def scale2x_batch_u8_s2d(yuv: torch.Tensor, fast: FastStack) -> torch.Tensor:
    """Throughput 2x step in the pixel-major polyphase layout: f32 YUV
    [N, h, w, 3] -> u8 BGR [N, h, w, 12] (channel (A*2+B)*3 + c). The host
    interleave to [N, 2h, 2w, 3] is a zero-flop u8 reshape (d2s_host)."""
    u8 = saturate_cast_u8(yuv_to_bgr(scale2x_yuv_s2d(yuv, fast)))
    n, h, w = u8.shape[:3]
    return u8.reshape(n, h, w, 12)


def _uv_phases_cmajor(yuv: torch.Tensor) -> torch.Tensor:
    """Channel-major polyphase U/V for the kernel's u8 tail: f32 YUV
    [N, h, w, 3] -> [N, h, w, 8] (u phases 0:4, v phases 4:8). The JAX
    package pads it to its kernel's tile grid; the port's kernel has no
    grid."""
    n, h, w, _ = yuv.shape
    with trace.span("w2x.tail", on=yuv):
        phases = resize2x_phases(yuv[..., 1:3], CUBIC, h_axis=1)  # [N,h,w,2,4]
        return phases.reshape(n, h, w, 8)


FUSED_TAIL = os.environ.get("W2X_TAIL", "xla")
if FUSED_TAIL not in ("xla", "kernel"):   # fail fast on typos: a bad value
    raise ValueError(                     # would silently select a tail
        f"W2X_TAIL must be 'xla' or 'kernel', got {FUSED_TAIL!r}")
YDENSE = os.environ.get("W2X_YDENSE", "") == "1"
# The JAX package's two switches for the scale step, read from its own
# environment variables so that a user's setting carries over.
# "xla" (default): the conv stack emits Y (stack_scale) and the bicubic U/V
# + YUV->BGR + saturating cast run as the dense PyTorch tail
# (_tail_u8_cmajor); the name is the JAX package's, where that tail is an
# XLA program. With YDENSE the stack's last layer stores Y phase-chunked
# and dense (stack_scale_dense) and the tail un-chunks it: bit-equal output.
# "kernel": the tail runs inside the kernel's last layer
# (stack_scale_fused_u8), fed the polyphase U/V (_uv_phases_cmajor); Y goes
# from the last LeakyReLU into the colour map in f32, so in bf16 storage it
# is rounded once less than under "xla".


def _combine_u8_cmajor(y2, u2, v2, n, h, w):
    """Flat [n, h, w*4] Y/U/V phase planes -> uint8 BGR in CHANNEL-MAJOR
    polyphase layout [n, h, w, 16] (lane c*4+phase, lanes 12:16 zero).
    Same math as yuv_to_bgr / saturate_cast_u8, in the same f32 order."""
    chans = [c.reshape(n, h, w, 4) for c in combine_u8_cmajor(y2, u2, v2)]
    chans.append(torch.zeros_like(chans[0]))
    return torch.cat(chans, dim=-1)                          # [n, h, w, 16]


def _tail_u8_cmajor(y_s2d: torch.Tensor, yuv: torch.Tensor) -> torch.Tensor:
    """Dense u8/BGR scale tail: converted-Y s2d [N,h,w,4] + f32 YUV
    [N,h,w,3] -> u8 BGR cmajor [N,h,w,16] (interleave with
    d2s_host_cmajor)."""
    n, h, w, _ = yuv.shape
    with trace.span("w2x.tail", on=yuv):
        ph = resize2x_phases(yuv[..., 1:3], CUBIC, h_axis=1)  # [n,h,w,2,4]
        y2 = y_s2d[:, :h, :w, :].to(torch.float32).reshape(n, h, w * 4)
        u2 = ph[..., 0, :].reshape(n, h, w * 4)
        v2 = ph[..., 1, :].reshape(n, h, w * 4)
        return _combine_u8_cmajor(y2, u2, v2, n, h, w)


def _tail_u8_cmajor_dense(ydense: torch.Tensor, yuv: torch.Tensor,
                          tc: int) -> torch.Tensor:
    """The same tail fed by FastStack.scale_dense's phase-chunked layout:
    un-chunk, then _tail_u8_cmajor."""
    _, h, w, _ = yuv.shape
    return _tail_u8_cmajor(dense_to_s2d(ydense, tc, h, w), yuv)


def _fused_step(yuv: torch.Tensor, fast: FastStack,
                y: "torch.Tensor | None" = None) -> torch.Tensor:
    """One 2x step to u8 BGR cmajor, by FUSED_TAIL and YDENSE: the
    conv-stack kernel + the dense tail, or the kernel with the tail in its
    last layer. `y` overrides the luma plane (chained steps pass a denoised
    plane; the tail reads only yuv's U/V)."""
    if y is None:
        y = yuv[..., 0]
    if FUSED_TAIL == "xla":
        if YDENSE:
            ydense, tc = fast.scale_dense(y)
            return _tail_u8_cmajor_dense(ydense, yuv, tc)
        return _tail_u8_cmajor(fast.scale(y), yuv)
    return fast.scale_fused_u8(y, _uv_phases_cmajor(yuv))


BAND_ROWS = 1152     # low-res rows per banded dispatch (large frames)
BAND_PX = 2 * 1152 * 3840   # low-res px per dispatch, batch included: rows
#                      alone don't bound device memory, so
#                      scale2x_batch_u8_fused caps rows at
#                      BAND_PX / (batch * width)
_BAND_HALO = 4       # one-sided receptive radius of the whole 2x step


_NOISE_HALO = 8      # full-res rows: the noise stack's 7-row radius,
#                      rounded up to keep band starts on even (s2d) rows


def _bands(h: int, band_rows: int, halo: int = _BAND_HALO, align: int = 1):
    """Row bands of a tall frame: (slice start, size, first output row,
    output rows). Bands overlap by `halo` rows on each side, so every
    band's kept rows are exact; all interior bands share one size, and
    band heights are multiples of `align` (the noise path passes 2 so that
    every band keeps s2d row parity)."""
    n_bands = -(-h // band_rows)
    rows = align * (-(-h // (align * n_bands)))   # no oversized tail band
    size = min(h, rows + 2 * halo)
    for b0 in range(0, h, rows):
        s = min(max(0, b0 - halo), h - size)
        yield s, size, b0 - s, min(rows, h - b0)


def _band_rows(band_rows: int, n: int, w: int) -> int:
    # the per-dispatch volume cap counts the batch too (see BAND_PX)
    return max(64, min(band_rows, BAND_PX // max(1, n * w)))


def scale2x_batch_u8_fused(yuv: torch.Tensor, fast: FastStack,
                           band_rows: int = BAND_ROWS,
                           y: "torch.Tensor | None" = None) -> torch.Tensor:
    """Throughput 2x step: f32 YUV [N, h, w, 3] -> uint8 BGR in
    CHANNEL-MAJOR polyphase layout [N, h, w, 16] (lane c*4 + phase, lanes
    12:16 zero). Interleave with d2s_host_cmajor. FUSED_TAIL and YDENSE
    choose where the tail runs and how the kernel stores Y (_fused_step).

    Frames taller than the band limit run in row bands with a
    _BAND_HALO-row overlap each side; band outputs are exact (the step's
    one-sided receptive radius is 4 low-res rows, true edges keep
    replicate semantics)."""
    n, h, w, _ = yuv.shape
    with trace.span("w2x.scale_step", on=yuv, n=n, size=(h, w),
                    out_px=4 * n * h * w):
        band_rows = _band_rows(band_rows, n, w)
        if h <= band_rows:
            return _fused_step(yuv, fast, y=y)
        outs = []
        for s, size, lo, nrows in _bands(h, band_rows):
            with trace.span("w2x.band", on=yuv, rows=size, kept=nrows):
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


def _noise_band_rows(band_rows: int, n: int, w: int) -> int:
    # the scale step's per-dispatch cap, BAND_PX low-res px, read as
    # 4 * BAND_PX full-res px and rounded to an even row count
    return max(128, min(band_rows, 2 * (2 * BAND_PX // max(1, n * w))))


def noise_y_batch_fast(y_in: torch.Tensor, fast: FastStack,
                       band_rows: int = 2 * BAND_ROWS,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Denoise a luma batch [N, h, w] -> [N, h, w] (out_dtype, default
    f32) through the conv-stack kernel. Tall frames run in row bands
    (full-res rows, even band heights, an _NOISE_HALO-row overlap each
    side); an odd height is edge-padded to even first so that the bands
    keep s2d parity. out_dtype=None keeps the kernel's storage dtype: a
    chain passes that straight to the scale step's `y=` (which casts to
    its own dtype), with no f32 round trip between two bf16 stacks."""
    n, h, w = y_in.shape

    def cast(y):
        return y if out_dtype is None else y.to(out_dtype)

    with trace.span("w2x.noise_step", on=y_in, n=n, size=(h, w),
                    out_px=n * h * w):
        band_rows = _noise_band_rows(band_rows, n, w)
        if h <= band_rows:
            return cast(fast.noise(y_in))
        if h % 2:
            y_in = torch.cat([y_in, y_in[:, -1:]], dim=1)
        parts = []
        for s, size, lo, nrows in _bands(y_in.shape[1], band_rows,
                                         _NOISE_HALO, 2):
            with trace.span("w2x.band", on=y_in, rows=size, kept=nrows):
                parts.append(
                    cast(fast.noise(y_in[:, s:s + size])[:, lo:lo + nrows]))
        return torch.cat(parts, dim=1)[:, :h]


def noise_batch_fast(yuv: torch.Tensor, fast: FastStack,
                     band_rows: int = 2 * BAND_ROWS) -> torch.Tensor:
    """Kernel-path twin of noise_batch: f32 YUV [N, h, w, 3] -> same shape
    with Y denoised (banding as in noise_y_batch_fast)."""
    y = noise_y_batch_fast(yuv[..., 0], fast, band_rows)
    return _with_y(yuv, y.to(yuv.dtype))


def _tail_u8_cmajor_noise(ys: torch.Tensor, yuv: torch.Tensor) -> torch.Tensor:
    """Dense u8/BGR noise tail: denoised Y s2d [N, h/2, w/2, 4] + the
    input's f32 YUV [N, h, w, 3] (h, w even) -> u8 BGR cmajor
    [N, h/2, w/2, 16] (interleave with d2s_host_cmajor). U/V pass through
    the noise step untouched, so their phases are the s2d split of the
    input planes."""
    n, h, w, _ = yuv.shape
    hl, wl = h // 2, w // 2
    with trace.span("w2x.tail", on=yuv):
        y2 = ys.to(torch.float32).reshape(n, hl, wl * 4)
        uv = yuv[..., 1:3]
        ph = torch.stack([uv[:, a::2, b::2, :] for a in (0, 1)
                          for b in (0, 1)], dim=3)           # [n,hl,wl,4,2]
        u2 = ph[..., 0].reshape(n, hl, wl * 4)
        v2 = ph[..., 1].reshape(n, hl, wl * 4)
        return _combine_u8_cmajor(y2, u2, v2, n, hl, wl)


def noise_batch_u8_fused(yuv: torch.Tensor, fast: FastStack,
                         band_rows: int = 2 * BAND_ROWS) -> torch.Tensor:
    """Throughput noise step: f32 YUV [N, h, w, 3] (h, w even; callers with
    odd frames use noise_batch_fast) -> u8 BGR cmajor [N, h/2, w/2, 16]
    (lane c*4 + s2d phase); interleave with d2s_host_cmajor. Tall frames
    band as in noise_y_batch_fast; a band's kept rows are u8 rows
    (b0 - s) // 2 onwards, in s2d rows."""
    n, h, w, _ = yuv.shape
    if h % 2 or w % 2:
        raise ValueError(f"noise_batch_u8_fused needs even dims, got "
                         f"{h}x{w} (use noise_batch_fast)")
    with trace.span("w2x.noise_step", on=yuv, n=n, size=(h, w),
                    out_px=n * h * w):
        band_rows = _noise_band_rows(band_rows, n, w)
        if h <= band_rows:
            return _tail_u8_cmajor_noise(fast.noise_s2d(yuv[..., 0]), yuv)
        parts = []
        for s, size, lo, nrows in _bands(h, band_rows, _NOISE_HALO, 2):
            with trace.span("w2x.band", on=yuv, rows=size, kept=nrows):
                band = yuv[:, s:s + size]
                u8 = _tail_u8_cmajor_noise(fast.noise_s2d(band[..., 0]), band)
                parts.append(u8[:, lo // 2:(lo + nrows) // 2])
        return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# UpCUNet (models/cunet.py): an RGB 2x step over fixed tiles.
# ---------------------------------------------------------------------------

CUNET_HALO = 18            # input pixels of context each side of a tile
CUNET_CHUNK_BYTES = 24 << 30   # device bytes the tiles of one chunk may hold


def cunet_tiles(x: torch.Tensor, tile: int) -> "tuple[torch.Tensor, int, int]":
    """f32 RGB [n, h, w, 3] -> (tiles [n * ny * nx, tile, tile, 3], ny,
    nx): the frame padded by CUNET_HALO pixels of edge replicate on every
    side and its far sides further, replicate, to a multiple of the step
    tile - 2 CUNET_HALO; tiles cut at that step, image-major, then row,
    then column. Each tile's output covers 2 step pixels a side of the
    output, with no overlap."""
    n, h, w, c = x.shape
    step = tile - 2 * CUNET_HALO
    ny, nx = -(-h // step), -(-w // step)
    xp = F.pad(x.permute(0, 3, 1, 2),
               (CUNET_HALO, CUNET_HALO + nx * step - w,
                CUNET_HALO, CUNET_HALO + ny * step - h), mode="replicate")
    t = xp.unfold(2, tile, step).unfold(3, tile, step)   # [n,c,ny,nx,S,S]
    return (t.permute(0, 2, 3, 4, 5, 1).reshape(n * ny * nx, tile, tile, c),
            ny, nx)


def cunet_stitch(out: torch.Tensor, n: int, ny: int, nx: int, h: int,
                 w: int) -> torch.Tensor:
    """Tile outputs [n * ny * nx, o, o, 3] RGB -> frames [n, h, w, 3] BGR:
    laid side by side in cunet_tiles' order, cropped, channels reversed."""
    o = out.shape[1]
    frames = (out.reshape(n, ny, nx, o, o, 3).permute(0, 1, 3, 2, 4, 5)
              .reshape(n, ny * o, nx * o, 3))
    return frames[:, :h, :w].flip(-1)


def cunet_chunk(model: CunetModel) -> int:
    """Tiles one forward pass takes: as many as CUNET_CHUNK_BYTES holds at
    about four 64-channel bf16 planes of the tile's output size each (the
    live activations of UNet2's full-resolution end)."""
    side = 2 * model.tile
    per_tile = 4 * side * side * 64 * torch.finfo(model.dtype).bits // 8
    return max(1, CUNET_CHUNK_BYTES // per_tile)


def upcunet2x_batch_u8(x: torch.Tensor, model: CunetModel) -> torch.Tensor:
    """UpCUNet's batched 2x step: f32 RGB in [0, 1], [n, h, w, 3] (the u8
    BGR frame / 255, channels reversed) -> u8 BGR [n, 2h, 2w, 3]. The frame
    is cut into model.tile-pixel tiles (cunet_tiles), each converted alone
    (its SE means over itself; ops/unet.py), in chunks of cunet_chunk tiles,
    and the tiles' u8 outputs stitched (cunet_stitch). Spans: the step
    ("w2x.cunet_step": n, size, tiles, out_px), the pad and cut and the
    stitch ("w2x.cunet.tiles"), and below the forward pass's own."""
    n, h, w, _ = x.shape
    with trace.span("w2x.cunet_step", on=x, n=n, size=(h, w),
                    out_px=4 * n * h * w) as step:
        with trace.span("w2x.cunet.tiles", on=x):
            tiles, ny, nx = cunet_tiles(x, model.tile)
            tiles = tiles.to(model.dtype).contiguous()
        step.set(tiles=tiles.shape[0])
        k = cunet_chunk(model)
        out = torch.cat([upcunet_tiles_u8(tiles[i:i + k], model)
                         for i in range(0, tiles.shape[0], k)])
        with trace.span("w2x.cunet.tiles", on=x):
            return cunet_stitch(out, n, ny, nx, 2 * h, 2 * w).contiguous()


def unit_rgb(bgr_u8: torch.Tensor) -> torch.Tensor:
    """u8 BGR [..., 3] -> f32 RGB in [0, 1], UpCUNet's input."""
    return u8_to_unit_f32(bgr_u8).flip(-1)


def cunet_dtype(cfg: Config, device: torch.device) -> torch.dtype:
    """An UpCUNet's storage dtype: compute_dtype where it is explicit; under
    "auto" bf16 on the card (csrc/mma.cu's layers), f32 on the CPU."""
    if cfg.compute_dtype == "float32" or (cfg.compute_dtype == "auto"
                                          and device.type != "cuda"):
        return torch.float32
    return torch.bfloat16


def cunet_params(cfg: Config) -> dict:
    """cfg's UpCUNet parameters: its model_file (models/cunet.py:
    load_params), else drawn from its model_seed."""
    if cfg.model_file:
        if not os.path.exists(cfg.model_file):
            raise FileNotFoundError(f"UpCUNet weights not found: "
                                    f"{cfg.model_file}")
        return cunet.load_params(cfg.model_file)
    if cfg.model_seed is not None:
        return cunet.init_params(cfg.model_seed)
    raise FileNotFoundError("an UpCUNet needs its weights: a model file "
                            "(the port's format) or a model seed")


def _build_fast(params, scale_input: bool, cfg: Config, device: torch.device,
                dtype=None) -> "FastStack | None":
    """Resolve cfg.use_pallas to a FastStack or None (non-kernel path).
    "auto" enables the kernel on a CUDA device; True anywhere (its plain
    version on the CPU). An architecture the kernel does not take runs on
    the non-kernel path, with a logged warning. `dtype` overrides the
    Config's kernel dtype (see _noise_dtype_for)."""
    want = cfg.use_pallas
    if want is False or (want == "auto" and device.type != "cuda"):
        return None
    if validate_params(params) != WAIFU2X_7LAYER:
        log.warning("conv-stack kernel unavailable (architecture is not "
                    "the flagship 7-layer model); using the non-kernel path")
        return None
    return FastStack.build(params, scale_input,
                           dtype=dtype or _kernel_dtype(cfg), device=device)


def _noise_dtype_for(cfg: Config) -> "torch.dtype | None":
    """Kernel dtype override for the noise stack on the single-image
    surface (Converter, convert_image). Two chained bf16 stacks compound
    their rounding: the scale stack amplifies the noise stack's error, and
    the JAX package measured a bf16 noise->scale chain below the 50 dB bar
    on pure-random content. An f32 noise stack, about a fifth of the
    chain's work, lifts it back over. Honoured only under
    compute_dtype="auto"; an explicit choice wins. Throughput entry points
    (noise_batch_fast and friends called directly) keep bf16."""
    if cfg.mode == "noise_scale" and cfg.compute_dtype == "auto":
        return torch.float32
    return None


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
    """Loaded-models pipeline front end (model resolution main.cpp:82-121
    + the phase drivers)."""

    cfg: Config
    device: torch.device
    noise_model: "SRCNN | None" = None
    scale_model: "SRCNN | None" = None
    fast_noise: "FastStack | None" = None
    fast_scale: "FastStack | None" = None
    # cfg.arch "upcunet": the model, and every image takes its 2x step
    cunet: "CunetModel | None" = None
    # MeshPipelines by mesh shape (parallel/mesh_pipeline.py), built lazily
    _pipes: dict = dataclasses.field(default_factory=dict, repr=False)
    _mesh_warned: bool = dataclasses.field(default=False, repr=False)

    def _mesh_warn_once(self, msg: str, *args) -> None:
        if not self._mesh_warned:
            self._mesh_warned = True
            log.warning(msg, *args)

    def _mesh_pipe(self, h: int, w: int):
        """cfg.mesh resolved to a MeshPipeline for this image size, or None
        (one device), by the JAX package's rules: "off" is None; the mesh
        needs the kernel stacks this mode uses (else one warning, unless
        "auto", and one device); "auto" acts only on a host with two or
        more cards, the spatial split by auto_spatial_shape; an explicit
        shape, (1, 1, 1) included, is built over the first devices of
        parallel.mesh.local_devices (the cards, or the CPU positions), and
        one that needs more devices than there are warns once and runs on
        one device. Pipelines are cached by shape; an image smaller than
        the mesh's min_image_hw runs on one device."""
        spec = self.cfg.mesh_shape()
        if spec == "off":
            return None
        need = []
        if self.cfg.mode in ("scale", "noise_scale"):
            need.append(self.fast_scale)
        if self.cfg.mode in ("noise", "noise_scale"):
            need.append(self.fast_noise)
        if any(f is None for f in need):
            if spec != "auto":
                self._mesh_warn_once("a mesh needs the kernel stacks (the "
                                     "flagship 7-layer model, use_pallas not "
                                     "False); running single-device")
            return None
        from waifu2x_torch.parallel.mesh_pipeline import (
            MeshPipeline, auto_spatial_shape, make_mesh3)
        devices = local_devices(self.device)
        if spec == "auto":
            if self.device.type != "cuda" or len(devices) < 2:
                return None
            spec = auto_spatial_shape(len(devices), h, w)
            if spec == (1, 1, 1):
                return None
        n_need = math.prod(spec)
        if n_need > len(devices):
            self._mesh_warn_once("mesh %s needs %d devices, have %d; running "
                                 "single-device", spec, n_need, len(devices))
            return None
        if spec not in self._pipes:
            self._pipes[spec] = MeshPipeline(
                make_mesh3(spec, devices[:n_need]),
                fast_scale=self.fast_scale, fast_noise=self.fast_noise,
                mode=self.cfg.mode, scale_ratio=self.cfg.scale_ratio)
        pipe = self._pipes[spec]
        mh, mw = pipe.min_image_hw()
        if h < mh or w < mw:
            return None
        return pipe

    def _fast_ok(self, fast: "FastStack | None", px: int) -> bool:
        """Use the kernel for this plane? 'auto' keeps tiny images on the
        non-kernel path for fidelity (SMALL_IMG_PX); use_pallas=True
        honours the user's choice at any size. `px` is the pixel count of
        the plane handed to the phase: the full-res plane for noise, the
        low-res input for a scale step."""
        if fast is None:
            return False
        return self.cfg.use_pallas is True or px >= SMALL_IMG_PX

    @classmethod
    def from_params(cls, cfg: Config, noise_params=None, scale_params=None,
                    device="cuda") -> "Converter":
        """A Converter over HWIO parameters: the models and kernel stacks of
        whichever of the two is given."""
        conv = cls(cfg, resolve_device(device))
        if noise_params is not None:
            conv.noise_model = SRCNN.from_params(noise_params).to(conv.device)
            conv.fast_noise = _build_fast(noise_params, False, cfg,
                                          conv.device, _noise_dtype_for(cfg))
        if scale_params is not None:
            conv.scale_model = SRCNN.from_params(scale_params).to(conv.device)
            conv.fast_scale = _build_fast(scale_params, True, cfg,
                                          conv.device)
        return conv

    @classmethod
    def from_cunet_params(cls, cfg: Config, params: dict,
                          device="cuda") -> "Converter":
        """A Converter over UpCUNet parameters (models/cunet.py), in the
        dtype cunet_dtype gives."""
        conv = cls(cfg, resolve_device(device))
        conv.cunet = CunetModel.build(params, cunet_dtype(cfg, conv.device),
                                      conv.device)
        return conv

    @classmethod
    def from_config(cls, cfg: Config, device="cuda") -> "Converter":
        resolve_device(device)   # no card: raise before loading anything
        if cfg.arch == "upcunet":
            return cls.from_cunet_params(cfg, cunet_params(cfg), device)
        noise_params = scale_params = None
        if cfg.mode in ("noise", "noise_scale"):
            noise_params = load_model_json(
                model_file_for(cfg.model_dir, True, cfg.noise_level))
        if cfg.mode in ("scale", "noise_scale"):
            scale_params = load_model_json(model_file_for(cfg.model_dir,
                                                          False))
        return cls.from_params(cfg, noise_params, scale_params, device)

    def _apply_noise(self, yuv: torch.Tensor) -> torch.Tensor:
        if self._fast_ok(self.fast_noise, yuv.shape[0] * yuv.shape[1]):
            # noise_batch_fast applies the BAND_PX per-dispatch cap, so a
            # huge single image bands like the batch paths
            return noise_batch_fast(yuv[None], self.fast_noise)[0]
        return _noise_phase(yuv, self.noise_model, self.cfg)

    def _apply_scale_iter(self, yuv: torch.Tensor) -> torch.Tensor:
        if self._fast_ok(self.fast_scale, yuv.shape[0] * yuv.shape[1]):
            return scale2x_batch_fast(yuv[None], self.fast_scale)[0]
        return _scale_step(yuv, self.scale_model, self.cfg)

    def process_yuv(self, yuv: torch.Tensor) -> torch.Tensor:
        if self.cunet is not None:
            raise ValueError("an UpCUNet converts RGB, not YUV: use "
                             "process_bgr_u8")
        if self.noise_model is not None:
            yuv = self._apply_noise(yuv)
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
        kernel-path 2x iteration (no shrink after it), run the noise step
        and any earlier iterations as usual, the last iteration through
        scale2x_batch_u8_fused, and interleave the u8 result on the host.
        Returns the u8 BGR image, or None when the conversion does not end
        that way (noise only, shrink step, non-kernel path, tiny image)."""
        if self.scale_model is None:
            return None
        iters, shrink = scale_plan(self.cfg.scale_ratio)
        if iters < 1 or shrink != 0.0:
            return None
        h, w = yuv.shape[0], yuv.shape[1]
        hN, wN = h << (iters - 1), w << (iters - 1)  # last iteration input
        if not self._fast_ok(self.fast_scale, hN * wN):
            return None
        if self.noise_model is not None:
            yuv = self._apply_noise(yuv)
        for _ in range(iters - 1):
            yuv = self._apply_scale_iter(yuv)
        out = scale2x_batch_u8_fused(yuv[None], self.fast_scale)
        return d2s_host_cmajor(out.cpu().numpy())[0]

    def process_bgr_u8(self, bgr_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR in, uint8 BGR out — the whole main.cpp math path. On a
        mesh (cfg.mesh; _mesh_pipe) the whole chain runs sharded when the
        image qualifies for the kernel path, else on one device."""
        if self.cunet is not None:
            img = torch.from_numpy(np.ascontiguousarray(bgr_u8)).to(
                self.device)
            return upcunet2x_batch_u8(unit_rgb(img)[None],
                                      self.cunet)[0].cpu().numpy()
        h, w = bgr_u8.shape[0], bgr_u8.shape[1]
        pipe = self._mesh_pipe(h, w)
        if pipe is not None and self._fast_ok(
                self.fast_scale or self.fast_noise, h * w):
            return pipe.convert_bgr_u8(bgr_u8[None])[0]
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
        if self.scale_model is not None or self.cunet is not None:
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
    HWIO tensors). Parameters the mode does not use are ignored, as in the
    JAX package."""
    if cfg.mode not in ("noise", "noise_scale"):
        noise_params = None
    if cfg.mode not in ("scale", "noise_scale"):
        scale_params = None
    return Converter.from_params(cfg, noise_params, scale_params,
                                 device).process_bgr_u8(bgr_u8)
