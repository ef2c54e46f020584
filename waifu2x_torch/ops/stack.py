"""The conv stack's hand-written CUDA kernels: their wrappers for the scale
path (`stack_scale`, the last layer's two other output forms
`stack_scale_dense` and `stack_scale_fused_u8`, and the truncated stack
`stack_scale_upto`) and the noise path (`stack_noise_s2d`, `stack_noise`),
their plain PyTorch versions (`*_plain`) and the device-ready weights they
share (`prep_params`; one layout serves both paths).

Contracts (those of the JAX package's pallas_stack functions of the same
names):

    stack_scale(ylow [N, hl, wl], sp) -> Y_s2d [N, hl, wl, 4]
        Y_s2d[n, i, j, A*2+B] = convert_plane(nearest2x(ylow))[n, 2i+A, 2j+B]
    stack_scale_dense(ylow, sp, tc) -> (ydense [N, hl, nx*4*tc], tc)
        ydense[n, i, j*4tc + q*tc + c] = Y_s2d[n, i, j*tc + c, q], with
        nx = ceil(wl / tc) and zeros past wl; dense_to_s2d undoes it
    stack_scale_fused_u8(ylow, uvp [N, hl, wl, 8] f32, sp) -> u8 BGR
        [N, hl, wl, 16], lane c*4 + phase, lanes 12:16 zero: the YUV -> BGR
        map and the saturating cast of ops/color.py on the f32 Y (never
        rounded to the storage dtype) and the polyphase U/V (u phases 0:4,
        v phases 4:8)
    stack_noise_s2d(y [N, h, w], sp) -> Y_s2d [N, h/2, w/2, 4]  (h, w even)
        Y_s2d[n, i, j, A*2+B] = convert_plane(y)[n, 2i+A, 2j+B]
    stack_noise(y [N, h, w], sp) -> [N, h, w]  (any h, w)
        convert_plane of y edge-padded to even, cropped back to h x w
    stack_scale_upto(ylow, sp, upto) -> [N, hl, wl, 4]
        the scale stack stopped after layer `upto` (0..6): 4 values of
        that stage per s2d cell (B7, see the function); out="whole",
        "lane0" and "phase_taps" are the truncation probes' other forms

    conv3x3_mma(x [N, h, w, ci] bf16, wp, b) -> [N, h-2, w-2, co]
        one 3x3 layer + bias + LeakyReLU on csrc/mma.cu, keyed by its
        widths (ci, co) alone: the entry of UpCUNet's 3x3 layers

in the input's dtype where not said otherwise. Storage is f32 or bf16.
Products and sums are f32 (TF32 off, but for the f32 calls' layers 2-6,
three TF32 products a term held to 3e-5); in bf16 each layer's activation
is rounded to bf16 once after its LeakyReLU, and Y once at the end (not at
all on its way into the u8 map).

Layer 1 (1 -> 32) of every call runs on csrc/l1.cu (l1_layer alone,
l1_plain its plain version): the scale stack's from the low-res plane with
the JAX body's phase-summed weights (StackParams.w1s = ops/s2d.py:
pack_l1_scale, each sum rounded once to the storage dtype), the noise
stack's from the full-res plane with w1's 9 taps.

Layers 2-6 (widths 32-32-64-64-128-128, 99.5% of the stack's
multiply-adds) run on the tensor cores, by storage dtype. A bf16 call runs
them on csrc/mma.cu (conv3x3_bias_leaky_mma, bf16 x bf16 products, f32
sums, from weights packed by ops/s2d.py:pack_mma into StackParams.wm: a
persistent kernel, layers 2-5 with their weights resident in shared memory
and layer 6 with its outputs in two halves, each block keeping one half's
weights resident; its first form, one block a tile, is the timing
yardstick, mma_layer(..., persistent=False)); an f32 call as 3xTF32 on
csrc/mma_tf32.cu (conv3x3_bias_leaky_tf32: each product a*w as
a_lo*w_hi + a_hi*w_lo + a_hi*w_hi in TF32, within 3e-5 of f32, from
StackParams.wt = pack_mma_tf32; tf32_plan its plan). mma_layer is one such
layer alone (either dtype), mma_layer_plain its plain version from the
packed weights, mma_plan the bf16 kernels' tile, chunk and shared-memory
plan, mma_walk the persistent kernel's walk over the tiles; mma_chain is
the probe of its inner loop (tools/mma_probe.py). The C entry of the
persistent kernel is keyed by the layer's widths (ci, co), not by vgg_7's
layer index: vgg_7's layers and conv3x3_mma (UpCUNet's 3x3 layers of
widths 32 -> 64, 64 -> 64, 64 -> 128 and 128 -> 64) launch it alike, and
MMA_SHAPES counts its launches by (ci, co, route). The probes of
ops/probe.py also run variants that no product path takes: the
tensor-core layer under a zero-shift mask (zs: a tap on a zeroed axis
reads its own s2d cell) or with two accumulators (pp: the same function),
and layer 7 under a mask, folded (mma_layer(zs=, pp=), last_layer(zs=),
mma_plan(ci, co, zs, pp)).

Layer 7 (128 -> 1) of every stack call is the JAX body's folded tap
product (csrc/l7.cu): per s2d cell of the layer-6 plane one f32 product
[512] x [512, 16] with StackParams.w7f = pack_l7_fold(w7), then Y as four
shifted 4-lane slices of those partials added in order, the bias, LeakyReLU
and the output form; l7_fold_plain is its plain version (last_layer_plain
the same layer as nine taps summed per pixel). A bf16 call runs it on the
tensor cores (l7_fold), an f32 call with FFMA on the 4 x 9 x 128 entries
of w7f that are not zero, read from w7 itself (l7_fold_f32). The int8
layer 6's tile-major planes take the same kernels, each tile a plane, its
Y written at the image's cells and cropped (l7_tiles_plain;
last_layer_tiles alone). Under a zero-shift mask (the probes' layer 7, s2d
on a plane) the fold's shift-sum reads a zeroed axis' own cell of Zt
(l7_fold_plain(zs=)). The truncation's two tap forms (stack_scale_upto at
upto 6) are output forms of the same fold: out="cell" stores Zt's lanes 0-3
(l7_fold_plain(taps=True); _taps_plain the same partials as taps summed
per phase), out="phase_taps" the same lanes from StackParams.w7p =
pack_l7_ptaps(w7), whose rows 0-127 hold w7's taps 0-3, the kernel reading
pixel (0, 0) of each cell alone (_phase_taps_plain). L7_LAUNCHES counts
every layer-7 launch by kernel.

Layer 6 (128 -> 128, half of the stack's multiply-adds) has three forms,
chosen by the arguments `l6_i8` and `l6_wino` of every wrapper; None, the
default, reads the module switches L6_I8 and L6_WINO, which are set from
the environment variables W2X_L6_I8=1 and W2X_L6_WINO=1 when this module
is imported (the JAX package's names, so a user's setting carries over).
Both at once raise ValueError.
  direct  the tensor-core layer of layers 2-5 (B1/B2).
  wino    (B5) Winograd F(2x2, 3x3): the weights U = G g G^T (ops/s2d.py:
          pack_wino) are rounded to the storage dtype as in the JAX
          package; V = B^T d B is formed in f32 from the stored layer-5
          activation. Both dtypes run it on the tensor cores (csrc/wino.cu):
          a bf16 call on l6_wino_mma from StackParams.w6m, with V rounded to
          bf16 once before the products; an f32 call on l6_wino_tf32 from
          StackParams.w6t, V kept in f32 and each product V*U taken as three
          TF32 products (the split of the f32 layers 2-6), within 3e-5 of
          f32. The JAX kernel forms V with bf16 adds, up to three roundings;
          the port rounds it once on purpose. wino_layer is layer 6 alone,
          wino_layer_plain the plain version of the kernels' arithmetic
          (A^T folded per output row), _l6_wino_plain the transform's own
          (A^T M A), wino_plan their units and chunks.
  i8      (B4) int8 x int8 with exact int32 sums. Weights: per output
          channel sw = max(|w6|, 1e-12) / 127, w6q = clip(round(w6 / sw)).
          Activations: per TILE of (tr, tc) s2d cells, over the tile's
          window of layer 5's output, m = max |x5|, sx = max(m, 1e-8) *
          (1/127), x5q = clip(round(x5 * (1/sx))), round half to even;
          x6 = leaky(float(sum) * (sx * sw) + b6). The stack runs on the
          plane edge-extended to the tile grid, each tile's Y comes from
          layer 6 computed with that tile's own scale, and the result is
          cropped to the image. `tile=(tr, tc)` sets the tile (the JAX
          package's `tile` argument); None picks default_tile. The tile
          maxima come from layer 5's epilogue, as the JAX body takes them
          from the x5 it holds on chip: the layer-5 kernel's instance with
          them (csrc/mma.cu in bf16, csrc/mma_tf32.cu in f32;
          layer5_maxima alone, layer5_maxima_plain its plain version) adds
          each block's share of every tile window to m by atomicMax, giving
          tile_max_plain's maxima bit for bit. The layer runs on the int8
          tensor cores (csrc/i8.cu: l6_i8_mma, wgmma s8 x s8 -> s32, from
          StackParams.w6i = pack_mma_i8), l6_i8_layer_plain's values bit for
          bit. I8_LAUNCHES counts the layer's launches and the maxima's.

The kernels (csrc/l1.cu, csrc/mma.cu, csrc/mma_tf32.cu, csrc/i8.cu,
csrc/wino.cu, csrc/l7.cu and csrc/gather.cu, which replace
waifu2x_tpu/ops/pallas_stack.py:_run_stack/_stack_body in its
configurations B1, B2, B3, B6 and B7, B4, B5) launch once per layer: 7
times per call, upto + 1 for stack_scale_upto. See the notes at the top of
those files for design and bounds. csrc/epi.cu, UpCUNet's library-layer
epilogue (ops/unet.py:cunet_epilogue), is built and loaded with them. Each
library answers for its own error codes (w2x_error_string, common.cuh).

The wrappers take the plain version for a tensor on the CPU only. For a
CUDA tensor they launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_torch.ops import _build, color
from waifu2x_torch.ops.convstack import leaky_relu, no_tf32
from waifu2x_torch.ops.s2d import (
    _WINO_AT,
    _WINO_BT_TAPS,
    d2s,
    pack_l1_scale,
    pack_l7_fold,
    pack_l7_ptaps,
    pack_mma,
    pack_mma_i8,
    pack_mma_tf32,
    pack_wino,
    s2d,
    unpack_mma,
)
from waifu2x_torch.utils import trace

# (cin, cout) of the flagship architecture, the only one the stack takes
WIDTHS = ((1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
          (128, 1))
DTYPES = (torch.float32, torch.bfloat16)

# layer 6's form when a wrapper's l6_i8 / l6_wino argument is None
L6_I8 = os.environ.get("W2X_L6_I8", "0") == "1"
L6_WINO = os.environ.get("W2X_L6_WINO", "0") == "1"
I8_TILE = (64, 128)   # largest default int8 tile, in s2d cells

# launches of the stack wrappers' kernels; the plain versions add none, nor
# do the standalone wrappers mma_layer, mma_chain (these count under
# MID_LAUNCHES only), layer5_plane (MID_LAUNCHES and L1_LAUNCHES), l1_layer
# (L1_LAUNCHES only) and l6_i8_layer (L6_LAUNCHES and I8_LAUNCHES only)
LAUNCHES = 0
# the same launches by the wrapper that made them: "scale" (stack_scale,
# stack_scale_upto), "noise" (stack_noise, stack_noise_s2d), "dense"
# (stack_scale_dense), "fused_u8" (stack_scale_fused_u8), "probe" (the
# probes' stacks of ops/probe.py: stack_scale_pp, shift_stack, l4_shift)
KERNEL_LAUNCHES = {"scale": 0, "noise": 0, "dense": 0, "fused_u8": 0,
                   "probe": 0}
# layer 6's launches by its form, and under "upto" the launches of
# stack_scale_upto's own last kernel
L6_LAUNCHES = {"direct": 0, "i8": 0, "wino": 0, "upto": 0}
# the launches of layers 2-6 by the kernel that ran them ("mma": bf16 on
# the tensor cores, csrc/mma.cu; "mma_tf32": f32 on the tensor cores as
# 3xTF32, csrc/mma_tf32.cu; "mma_zs" and "mma_pp": the bf16 tile kernel
# under a zero-shift mask or with two accumulators, which only the probes
# run), and under "chain" those of the mma_chain probe (which count nowhere
# else). Each "mma" launch also counts under its route (MID_ROUTES):
# "mma_resident" the persistent kernel with all the layer's weights
# resident (layers 2-5), "mma_split" the persistent kernel with the outputs
# in two halves, a block keeping one half's weights resident (layer 6),
# "mma_tile" the tile kernel (persistent=False, the yardstick, and layer 5
# with B4's tile maxima)
MID_LAUNCHES = {"mma": 0, "chain": 0, "mma_zs": 0, "mma_pp": 0,
                "mma_tf32": 0, "mma_resident": 0, "mma_split": 0,
                "mma_tile": 0}
MID_ROUTES = ("mma_resident", "mma_split", "mma_tile")
# every launch of csrc/mma.cu's layer kernels without a probe variant (the
# MID_LAUNCHES "mma" ones), by (ci, co, route): route "resident", "split"
# or "tile" as MID_ROUTES less its "mma_"
MMA_SHAPES: dict = {}
# the launches of layer 1 (csrc/l1.cu: every stack call, l1_layer alone)
L1_LAUNCHES = {"l1": 0}
# the Winograd layer 6's launches by the kernel that ran them: "mma" bf16 on
# the tensor cores, "mma_tf32" f32 on them as 3xTF32 (both csrc/wino.cu;
# also wino_layer alone, which counts here only); L6_LAUNCHES["wino"]
# counts the form
WINO_LAUNCHES = {"mma": 0, "mma_tf32": 0}
# the int8 layer 6's launches ("mma": the int8 tensor cores, csrc/i8.cu)
# and the tile maxima's ("l5max": layer 5's instance with them in its
# epilogue, csrc/mma.cu, mma_tf32.cu; counted under MID_LAUNCHES too).
# L6_LAUNCHES["i8"] counts the form
I8_LAUNCHES = {"mma": 0, "l5max": 0}
# stack_scale_upto's gather (upto 0..5, csrc/gather.cu:upto_gather_tiled);
# counted under L6_LAUNCHES["upto"] too
GATHER_LAUNCHES = {"tiled": 0}
# every launch of a layer-7 kernel (of a stack, of last_layer and
# last_layer_tiles alone, of the probes' stacks, and the truncation's tap
# forms) by the kernel that ran it: "fold" the tensor-core fold (csrc/l7.cu,
# bf16, on a plane or the int8 layer's tiles), "fold_f32" the FFMA fold
# (csrc/l7.cu, f32, likewise; both under a zero-shift mask and in the tap
# forms too)
L7_LAUNCHES = {"fold": 0, "fold_f32": 0}
# the fold's launches in the truncation's two tap forms (stack_scale_upto at
# upto 6; counted under L7_LAUNCHES "fold" / "fold_f32" too): "taps"
# OUT_TAPS, the same-cell taps, "ptaps" OUT_PTAPS, the phase taps
TAP_LAUNCHES = {"taps": 0, "ptaps": 0}

# the last layer's output forms (csrc/common.cuh: OUT_*)
_OUT_S2D, _OUT_DENSE, _OUT_U8, _OUT_TAPS, _OUT_PTAPS = 0, 1, 2, 3, 4
# stack_scale_upto's output forms -> the upto values that take each
UPTO_OUTS = {"cell": range(7), "whole": range(6), "lane0": (0,),
             "phase_taps": (6,)}
# csrc/gather.cu's modes at upto = 0, by output form
_GATHER_LOWRES = {"cell": 1, "lane0": 2, "whole": 3}
_OUT_MODES = {"scale": _OUT_S2D, "noise": _OUT_S2D, "dense": _OUT_DENSE,
              "fused_u8": _OUT_U8}
DENSE_TC = 128   # widest dense chunk: four warps' contiguous stores per phase
_INV127 = float(np.float32(1.0 / 127.0))


def reset_launches() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for counts in (KERNEL_LAUNCHES, L6_LAUNCHES, MID_LAUNCHES, WINO_LAUNCHES,
                   L7_LAUNCHES, TAP_LAUNCHES, L1_LAUNCHES, I8_LAUNCHES,
                   GATHER_LAUNCHES):
        for kind in counts:
            counts[kind] = 0
    MMA_SHAPES.clear()


class StackParams(tuple):
    """prep_params' result: the seven (w, b) pairs, and as attributes layer
    6's weights in its two other forms:
      w6q  int32 [32, 9, 128]: w6 as int8, four input channels to a word
           (byte k of word [c4, t, co] is channel 4*c4 + k; unpack_w6q)
      w6s  f32 [128]: the int8 weights' scale per output channel
      w6i  int8 [8, 9, 128, 16]: w6q as the int8 tensor-core kernel reads
           it, pack_mma_i8(unpack_w6q(w6q))
      w6w  [16, 128, 128] in the storage dtype: pack_wino(w6)
      w6m  [16, 16, 128, 8] in the storage dtype: pack_mma of the same U as
           a 4 x 4 kernel (tap p = py*4 + px), its input channels in the
           order WINO_CI_ORDER, as csrc/wino.cu reads it (unpack_w6m)
      w6t  for f32 storage only (None for bf16): (hi, lo), each f32
           [32, 16, 128, 4], pack_mma_tf32 of the same U as a 4 x 4 kernel,
           its input channels in the order WINO_TF32_CI_ORDER, as
           csrc/wino.cu's f32 kernel reads it (unpack_w6t)
    and the weights of layers 2-6 as the tensor-core kernel reads them:
      wm   five tensors [ci/8, 9, co, 8] in the storage dtype:
           pack_mma(w_k) for k = 2..6
    and layer 7's as its folded tap product (csrc/l7.cu) reads them:
      w7f  [512, 16] in the storage dtype: pack_l7_fold(w7)
      w7p  [512, 16] in the storage dtype: pack_l7_ptaps(w7), the
           truncation's phase taps on the bf16 fold
    and layer 1's of the scale stack (csrc/l1.cu and every plain scale
    stack):
      w1s  [9, 128] in the storage dtype: pack_l1_scale(w1), each phase sum
           rounded once
    and, for f32 storage only (None for bf16), the 3xTF32 kernel's weights
    of layers 2-6 (csrc/mma_tf32.cu):
      wt   five (hi, lo) pairs of f32 [ci/4, 9, co, 4]: pack_mma_tf32(w_k)
           for k = 2..6"""


# csrc/wino.cu reads input channels 4j .. 4j+3 of a chunk of 16 in one load
# for the A fragment's k = 2j, 2j+1 and 2j+8, 2j+9: the weights' logical
# channel 16c + 8h + 2j + e holds physical channel 16c + 4j + 2h + e
WINO_CI_ORDER = torch.tensor([16 * c + 4 * ((k % 8) // 2) + 2 * (k // 8)
                              + k % 2 for c in range(8) for k in range(16)])


# csrc/wino.cu's f32 kernel reads input channels 2t, 2t+1 of a chunk of 8
# in one load for the A fragment's k = t and t + 4: the weights' logical
# channel 8c + 4e + t holds physical channel 8c + 2t + e
WINO_TF32_CI_ORDER = torch.tensor([8 * c + 2 * (k % 4) + k // 4
                                   for c in range(16) for k in range(8)])


def unpack_w6t(w6t) -> torch.Tensor:
    """StackParams.w6t -> U [16, 128, 128] as hi + lo in the natural channel
    order (pack_wino's layout, to 2^-21 relative)."""
    u = unpack_mma(w6t[0]) + unpack_mma(w6t[1])
    out = torch.empty_like(u)
    out[:, WINO_TF32_CI_ORDER] = u
    return out


def unpack_w6m(w6m: torch.Tensor) -> torch.Tensor:
    """StackParams.w6m -> U [16, 128, 128] in the natural channel order
    (pack_wino's layout)."""
    u = unpack_mma(w6m)
    out = torch.empty_like(u)
    out[:, WINO_CI_ORDER] = u
    return out


def unpack_w6q(w6q: torch.Tensor) -> torch.Tensor:
    """StackParams.w6q -> int8 [128, 9, 128], the layout of the f32 w6."""
    return (w6q.view(torch.int8).reshape(32, 9, 128, 4).permute(0, 3, 1, 2)
            .reshape(128, 9, 128))


def prep_params(params, dtype=torch.bfloat16, device="cuda") -> StackParams:
    """HWIO parameters -> the stack's weights: per layer (w [cin, 9, cout]
    in the storage dtype, tap t = dy*3 + dx; b [cout] f32), on `device`,
    with layer 6's int8 and Winograd forms as attributes (StackParams)."""
    if len(params) != len(WIDTHS):
        raise ValueError(f"the stack takes the {len(WIDTHS)}-layer flagship "
                         f"model, got {len(params)} layers")
    pairs = []
    for p, (ci, co) in zip(params, WIDTHS):
        w = torch.as_tensor(p["w"])
        if tuple(w.shape) != (3, 3, ci, co):
            raise ValueError(f"weight shape {tuple(w.shape)} != "
                             f"{(3, 3, ci, co)}")
        w = w.permute(2, 0, 1, 3).reshape(ci, 9, co)
        pairs.append((w.to(device, dtype).contiguous(),
                      torch.as_tensor(p["b"]).to(device, torch.float32)))
    sp = StackParams(pairs)
    w6 = torch.as_tensor(params[5]["w"]).detach().cpu().numpy()
    w6 = w6.astype(np.float32)
    # symmetric int8 per output channel, from the f32 weights
    sw = (np.maximum(np.abs(w6).max(axis=(0, 1, 2)), 1e-12)
          / 127.0).astype(np.float32)
    q = np.clip(np.round(w6 / sw), -127, 127).astype(np.int8)
    words = (torch.from_numpy(q).permute(2, 0, 1, 3).reshape(32, 4, 9, 128)
             .permute(0, 2, 3, 1).contiguous().view(torch.int32).squeeze(-1))
    sp.w6q = words.to(device).contiguous()
    sp.w6i = pack_mma_i8(torch.from_numpy(q).permute(2, 0, 1, 3)
                         .reshape(128, 9, 128)).to(device)
    sp.w6s = torch.from_numpy(sw).to(device)
    u = torch.from_numpy(pack_wino(w6))
    sp.w6w = u.to(device, dtype).contiguous()
    sp.w6m = (pack_mma(u[:, WINO_CI_ORDER].reshape(4, 4, 128, 128))
              .to(device, dtype).contiguous())
    sp.w6t = None if dtype != torch.float32 else tuple(
        t.to(device).contiguous() for t in pack_mma_tf32(
            u[:, WINO_TF32_CI_ORDER].reshape(4, 4, 128, 128)))
    sp.wm = tuple(pack_mma(torch.as_tensor(p["w"])).to(device, dtype)
                  .contiguous() for p in params[1:6])
    w7 = torch.as_tensor(params[6]["w"]).detach().cpu().float().numpy()
    sp.w7f = (torch.from_numpy(pack_l7_fold(w7)).to(device, dtype)
              .contiguous())
    sp.w7p = (torch.from_numpy(pack_l7_ptaps(w7)).to(device, dtype)
              .contiguous())
    w1 = torch.as_tensor(params[0]["w"]).detach().cpu().float().numpy()
    sp.w1s = (torch.from_numpy(pack_l1_scale(w1)).to(device, dtype)
              .contiguous())
    sp.wt = None if dtype != torch.float32 else tuple(
        tuple(t.to(device).contiguous()
              for t in pack_mma_tf32(torch.as_tensor(p["w"])))
        for p in params[1:6])
    return sp


class MmaPlan(NamedTuple):
    """How csrc/mma.cu runs one of layers 2-6 (mma_plan)."""
    tile: tuple        # output pixels (rows, cols) of one tile
    threads: int       # four warpgroups, one 8 x 8 m64 tile each (and, in
                       # the persistent kernel, the producer warp)
    kc: int            # input channels per staged chunk
    stages: int        # ring slots (persistent) or chunk buffers (tile)
    win_stride: int    # the staged window's k8 stride, in 16-byte units
    smem_bytes: int    # dynamic shared memory of the launch
    zs: int = 0        # zero-shift mask: 1 columns, 2 rows, 3 both
    pp: bool = False   # two accumulators, half the outputs each
    route: str = "tile"   # the MID_LAUNCHES route: "resident", "split"
                          # (the persistent kernel) or "tile"
    groups: int = 1       # consumer groups taking a block's tiles in turn
    l2_tile_bytes: int = 0   # bytes staged from L2 into shared memory for
                             # one tile: window copies (split: once a half)
                             # and, in the tile kernel, weight chunks
    resident_bytes: int = 0  # weights staged once a block (persistent)


SMEM_MAX = 232448      # what one block may use on an H100 (227 KB)
_MMA_TILE = 16
_SLAB = 18 * 18 * 16   # a k8 slab of the 18 x 18 window, as TMA lands it
# the persistent kernel: the window's k8 stride (16-byte units; 18 x 18
# rounded up so that each slab starts 128-byte aligned), its threads (four
# warpgroups and a producer warp) and the most ring slots it takes
_RES_STRIDE, _RES_THREADS, _RES_SLOTS = 328, 544, 8
# (kc, stages) per (ci, co), as csrc/mma.cu instantiates each layer shape
# (PERF.md has the times of the other chunkings that were tried on an H100):
# vgg_7's layers 2-6 on both kernels, and UpCUNet's 128 -> 64 on the
# persistent one alone (stages None: no tile kernel); UpCUNet's 32 -> 64,
# 64 -> 64 and 64 -> 128 layers take vgg_7's instances
_MMA_CHUNK = {(32, 32): (32, 1), (32, 64): (32, 1), (64, 64): (16, 2),
              (64, 128): (32, 2), (128, 128): (16, 2), (128, 64): (16, None)}


def has_mma(ci: int, co: int) -> bool:
    """Whether csrc/mma.cu's persistent kernel (conv3x3_mma) takes a bf16
    3x3 ci -> co layer: the routing of UpCUNet's 3x3 layers (ops/unet.py;
    128 -> 256 and 256 -> 128 stay on cuDNN)."""
    return (ci, co) in _MMA_CHUNK
# (kc, stages) of the variants csrc/mma.cu instantiates for the probes, by
# (ci, co, zs, pp): every vgg_7 layer 2-6 under each zero-shift mask and
# with two accumulators, in its own chunk plan but for 64 -> 128 under zs 3,
# whose four window copies in chunks of 32 would need 316 KB
_MMA_VARIANTS = {
    **{(ci, co, zs, False): _MMA_CHUNK[(ci, co)]
       for ci, co in WIDTHS[1:6] for zs in (1, 2, 3)},
    **{(ci, co, 0, True): _MMA_CHUNK[(ci, co)] for ci, co in WIDTHS[1:6]},
    (64, 128, 3, False): (16, 2)}
_ZS_COPIES = {0: 1, 1: 2, 2: 2, 3: 4}   # window copies a chunk stages


def _persistent_plan(ci: int, co: int) -> MmaPlan:
    """csrc/mma.cu's Res<ci, co, kc>: one block an SM; the layer's weights
    resident beside a ring of at least 3 window slots where they fit in
    SMEM_MAX (route "resident"), else the output channels in two halves, a
    block keeping one half's weights resident and computing that half of
    its tiles (route "split"); two consumer groups taking the block's tiles
    in turn where a block computes at most 64 outputs, else one; as many
    slots as fit, at most _RES_SLOTS, each with a full and an empty
    mbarrier; 128 bytes to align the base and the weights' mbarrier."""
    kc, _ = _MMA_CHUNK[(ci, co)]
    k8c, nchunk = kc // 8, ci // kc
    win_bytes = k8c * _RES_STRIDE * 16
    fits = 128 + 9 * ci * co * 2 + 3 * (win_bytes + 16) + 8 <= SMEM_MAX
    halves = 1 if fits else 2
    w_all = 9 * ci * (co // halves) * 2
    fixed = 128 + w_all + 8
    slots = min(_RES_SLOTS, (SMEM_MAX - fixed) // (win_bytes + 16))
    return MmaPlan((_MMA_TILE, _MMA_TILE), _RES_THREADS, kc, slots,
                   _RES_STRIDE, fixed + slots * (win_bytes + 16),
                   route="resident" if fits else "split",
                   groups=2 if co // halves <= 64 else 1,
                   l2_tile_bytes=halves * nchunk * k8c * _SLAB,
                   resident_bytes=w_all)


def mma_plan(ci: int, co: int, zs: int = 0, pp: bool = False,
             persistent: bool = True) -> MmaPlan:
    """The tensor-core kernels' plan for a ci -> co layer. The persistent
    kernel (the main path; zs = 0, no pp, persistent): _persistent_plan.
    The tile kernel (persistent=False, and every probe variant): a 16 x 16
    pixel tile per block, its 18 x 18 window and the 9 taps' weights
    staged per chunk of kc input channels in a ring of `stages` buffers,
    and the shared memory that takes (the larger of the ring and the
    epilogue's padded output tile). Under zero-shift mask zs each chunk
    stages _ZS_COPIES[zs] copies of the window; with pp the first half's
    output tile has a region of its own beside the ring. Both take the
    same chunk depth kc. The C entries take smem_bytes as an argument and
    refuse bytes that differ from their own count."""
    if (zs, pp) == (0, False) and persistent and (ci, co) in _MMA_CHUNK:
        return _persistent_plan(ci, co)
    if (zs, pp) == (0, False):
        chunk = _MMA_CHUNK.get((ci, co))
    else:
        chunk = _MMA_VARIANTS.get((ci, co, zs, bool(pp)))
    if chunk is None or chunk[1] is None:
        raise ValueError(f"no tensor-core kernel for a {ci} -> {co} layer "
                         f"with zs={zs!r}, pp={pp!r}")
    kc, stages = chunk
    k8c, win = kc // 8, _MMA_TILE + 2
    stride = win * win + (8 // k8c - win * win % 8 + 8) % 8
    ring = stages * k8c * (_ZS_COPIES[zs] * stride + 9 * co) * 16
    if pp:
        half = _MMA_TILE * _MMA_TILE * (co + 16)
        smem = max(ring, half) + half
    else:
        smem = max(ring, _MMA_TILE * _MMA_TILE * (2 * co + 16))
    if smem > SMEM_MAX:
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_MAX}")
    window = k8c * win * win * 16 * _ZS_COPIES[zs]
    return MmaPlan((_MMA_TILE, _MMA_TILE), 512, kc, stages, stride, smem,
                   zs, bool(pp),
                   l2_tile_bytes=ci // kc * (window + k8c * 9 * co * 16))


_TF32_KC, _TF32_STAGES = 8, 2


def tf32_plan(ci: int, co: int) -> MmaPlan:
    """The 3xTF32 kernel's plan for a ci -> co layer (csrc/mma_tf32.cu):
    mma_plan's 16 x 16 tile and four warpgroups, chunks of 8 input channels
    in a ring of 2 stages, each the chunk's 18 x 18 window [k4][row][col][4]
    f32 (k4 stride win_stride 16-byte units) and its w_hi and w_lo, beside
    the ring one a_lo window; the epilogue's padded f32 output tile reuses
    the ring. The C entry takes smem_bytes and refuses bytes that differ
    from its own count."""
    if (ci, co) not in WIDTHS[1:6]:
        raise ValueError(f"no 3xTF32 kernel for a {ci} -> {co} layer")
    k4c, win = _TF32_KC // 4, _MMA_TILE + 2
    stride = win * win + (8 // k4c - win * win % 8 + 8) % 8
    ring = (_TF32_STAGES * k4c * (stride + 2 * 9 * co) * 16
            + k4c * stride * 16)
    smem = max(ring, _MMA_TILE * _MMA_TILE * (4 * co + 16))
    if smem > SMEM_MAX:
        raise ValueError(f"{smem} bytes of shared memory exceed {SMEM_MAX}")
    return MmaPlan((_MMA_TILE, _MMA_TILE), 512, _TF32_KC, _TF32_STAGES,
                   stride, smem)


def mma_grid(n: int, hin: int, win: int) -> tuple:
    """(tile rows, tile columns, tiles) of the tensor-core kernels over an
    [n, hin, win] input plane: 16 x 16 tiles that cover the (hin-2) x
    (win-2) output, the ragged edge masked in the kernel. The tile kernel
    launches a block a tile."""
    nty, ntx = -(-(hin - 2) // _MMA_TILE), -(-(win - 2) // _MMA_TILE)
    return nty, ntx, n * nty * ntx


def mma_walk(tiles: int, plan: MmaPlan, sms: int = 132) -> list:
    """The persistent kernel's walk, as csrc/mma.cu's launch_mma and
    conv3x3_bias_leaky_mma make it on a card of `sms` SMs: for each block
    of the grid, the units it computes in order, as (tile, half) pairs
    (tiles numbered column fastest, then row and image, as mma_grid counts
    them; half 0 where the outputs are not split). The units: the tiles, or
    under the split route each tile's two output halves, unit v = (v // 2,
    v % 2). The grid: min(units, sms) blocks, rounded down to even under
    the split; block b takes units b, b + grid, ... (its consumer groups
    alternate: group g the entries g, g + groups, ... of its list)."""
    if plan.route not in ("resident", "split"):
        raise ValueError(f"no persistent walk for route {plan.route!r}")
    halves = 2 if plan.route == "split" else 1
    units = tiles * halves
    grid = min(units, sms)
    grid -= grid % halves
    return [[divmod(v, halves) for v in range(b, units, grid)]
            for b in range(grid)]


class WinoPlan(NamedTuple):
    """How a csrc/wino.cu kernel cuts the Winograd layer 6 (wino_plan)."""
    tile: tuple        # 2 x 2 output blocks (rows, cols) of one unit
    co: int            # output channels of one unit
    kc: int            # input channels per staged chunk


# (tile side, unit channels, chunk channels) of csrc/wino.cu's kernels
_WINO_PLANS = {torch.bfloat16: (8, 64, 16), torch.float32: (8, 32, 8)}


def wino_plan(dtype=torch.bfloat16) -> WinoPlan:
    """The tensor-core Winograd kernel's plan for a storage dtype: a unit is
    8 x 8 output blocks (16 x 16 pixels) and a share of the 128 output
    channels (bf16: a half; f32: a quarter, whose sums and 3xTF32 partials
    fit the registers), run in chunks of input channels (bf16 16, f32 8:
    one k8 step). The kernels are persistent, one CUDA block an SM walking
    over the units, and each owns its shared-memory plan."""
    t, co, kc = _WINO_PLANS[dtype]
    return WinoPlan((t, t), co, kc)


def l6_form(l6_i8=None, l6_wino=None) -> str:
    """Layer 6's form, "direct", "i8" or "wino", from a wrapper's two
    arguments (None reads the module switch)."""
    if l6_i8 is None:
        l6_i8 = L6_I8
    if l6_wino is None:
        l6_wino = L6_WINO
    if l6_i8 and l6_wino:
        raise ValueError("l6_i8 and l6_wino are mutually exclusive")
    return "i8" if l6_i8 else "wino" if l6_wino else "direct"


def default_tile(hl: int, wl: int) -> tuple:
    """The int8 tile for an hl x wl grid of s2d cells: the grid cut evenly
    into the fewest tiles of at most I8_TILE cells each way, so that the
    grid pads by less than one cell row and column per tile."""
    return tuple(-(-size // -(-size // cap))
                 for size, cap in zip((hl, wl), I8_TILE))


def _tiling(hl: int, wl: int, form: str, tile):
    """(tr, tc, ny, nx) of the int8 tile grid over hl x wl cells, or None
    for the forms that have no tiles."""
    if form != "i8":
        return None
    tr, tc = default_tile(hl, wl) if tile is None else tile
    if int(tr) != tr or int(tc) != tc or tr < 1 or tc < 1:
        raise ValueError(f"tile must be two positive ints, got {tile}")
    return int(tr), int(tc), -(-hl // int(tr)), -(-wl // int(tc))


def _check(ylow: torch.Tensor, sp, form: str = "direct") -> None:
    if ylow.dim() != 3 or min(ylow.shape) < 1:
        raise ValueError(f"the input must be a non-empty [N, h, w] plane, "
                         f"got shape {tuple(ylow.shape)}")
    if ylow.dtype not in DTYPES:
        raise TypeError(f"ylow must be float32 or bfloat16, got {ylow.dtype}")
    if not ylow.is_contiguous():
        raise ValueError("ylow must be contiguous")
    if len(sp) != len(WIDTHS):
        raise ValueError(f"expected {len(WIDTHS)} layers, got {len(sp)}")
    for k, ((w, b), (ci, co)) in enumerate(zip(sp, WIDTHS)):
        if tuple(w.shape) != (ci, 9, co) or tuple(b.shape) != (co,):
            raise ValueError(f"layer {k}: weights {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, want {(ci, 9, co)} / {(co,)}")
        if w.dtype != ylow.dtype or b.dtype != torch.float32:
            raise TypeError(f"layer {k}: weights must be {ylow.dtype} and "
                            f"bias float32, got {w.dtype} / {b.dtype}")
        if w.device != ylow.device or b.device != ylow.device:
            raise ValueError(f"layer {k}: weights on {w.device}, ylow on "
                             f"{ylow.device}")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"layer {k}: weights must be contiguous")
    extras = {"i8": ("w6q", "w6s", "w6i"), "wino": ("w6w",),
              "direct": ()}[form]
    for name in extras:
        t = getattr(sp, name, None)
        if t is None:
            raise ValueError(f"layer 6 as {form} needs prep_params' weights "
                             f"(StackParams.{name})")
        if t.device != ylow.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ylow.device}")
    if form == "wino" and sp.w6w.dtype != ylow.dtype:
        raise TypeError(f"w6w must be {ylow.dtype}, got {sp.w6w.dtype}")
    wm = getattr(sp, "wm", None)
    if wm is not None:
        _check_wm(wm, ylow)


def _check_wm(wm, x: torch.Tensor) -> None:
    """Checks of StackParams.wm against the tensor x it will meet."""
    if len(wm) != 5:
        raise ValueError(f"wm must hold layers 2-6, got {len(wm)} tensors")
    for k, (t, (ci, co)) in enumerate(zip(wm, WIDTHS[1:6]), 2):
        if tuple(t.shape) != (ci // 8, 9, co, 8):
            raise ValueError(f"wm, layer {k}: {tuple(t.shape)}, want "
                             f"{(ci // 8, 9, co, 8)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"wm, layer {k}: {t.dtype} on {t.device}, want "
                            f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"wm, layer {k}: must be contiguous")


def _w1s(sp, x: torch.Tensor) -> torch.Tensor:
    """StackParams.w1s, checked against the low-res plane x it will meet.
    Weights without that field (a bare tuple of (w, b) pairs, or
    StackParams built by hand) have their phase sums formed from the stored
    layer-1 weights (prep_params forms them from the f32 weights, so in
    bf16 the two round differently)."""
    w1s = getattr(sp, "w1s", None)
    if w1s is None:
        w1 = sp[0][0].detach().float().cpu().reshape(1, 3, 3, 32)
        w1s = (torch.from_numpy(pack_l1_scale(w1.permute(1, 2, 0, 3)
                                              .numpy()))
               .to(sp[0][0].device, sp[0][0].dtype))
    if tuple(w1s.shape) != (9, 128):
        raise ValueError(f"StackParams.w1s must be [9, 128], got "
                         f"{tuple(w1s.shape)}")
    if (w1s.device != x.device or not w1s.is_contiguous()
            or w1s.dtype != sp[0][0].dtype):
        raise TypeError(f"w1s must be contiguous {sp[0][0].dtype} on "
                        f"{x.device}, got {w1s.dtype} on {w1s.device}")
    return w1s


def _wt(sp, x: torch.Tensor, k: int) -> tuple:
    """StackParams.wt's (hi, lo) pair of layer k + 1 (k = 1..5), checked
    against the f32 plane x it will meet."""
    wt = getattr(sp, "wt", None)
    if wt is None or len(wt) != 5:
        raise ValueError("the 3xTF32 layers need prep_params' f32 "
                         "StackParams.wt")
    ci, co = WIDTHS[k]
    for t in wt[k - 1]:
        if tuple(t.shape) != (ci // 4, 9, co, 4) or t.dtype != torch.float32:
            raise ValueError(f"wt, layer {k + 1}: {tuple(t.shape)} "
                             f"{t.dtype}, want f32 {(ci // 4, 9, co, 4)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"wt, layer {k + 1}: must be contiguous on "
                             f"{x.device}")
    return wt[k - 1]


def _w7f(sp, x: torch.Tensor, phase_taps: bool = False) -> torch.Tensor:
    """StackParams.w7f (with phase_taps, w7p: the truncation's phase taps),
    checked against the layer-6 plane x it will meet. f32 weights without
    that field (a bare tuple of (w, b) pairs, which every wrapper takes in
    the direct form, as _w1s does for layer 1) have it packed from the
    stored w7, which in f32 is prep_params' own pack; bf16 weights need
    prep_params' (packed from the f32 weights, then rounded)."""
    name, pack = ("w7p", pack_l7_ptaps) if phase_taps else ("w7f",
                                                           pack_l7_fold)
    w7f = getattr(sp, name, None)
    if w7f is None and sp[6][0].dtype == torch.float32:
        w7 = sp[6][0].detach().cpu().reshape(128, 3, 3, 1).permute(1, 2, 0, 3)
        w7f = torch.from_numpy(pack(w7.numpy())).to(sp[6][0].device)
    if w7f is None or tuple(w7f.shape) != (512, 16):
        raise ValueError(f"the folded layer 7 needs prep_params' "
                         f"StackParams.{name} [512, 16]")
    if (w7f.device != x.device or not w7f.is_contiguous()
            or w7f.dtype != sp[6][0].dtype):
        raise TypeError(f"{name} must be contiguous {sp[6][0].dtype} on "
                        f"{x.device}, got {w7f.dtype} on {w7f.device}")
    return w7f


def _w6t(sp, x: torch.Tensor) -> tuple:
    """StackParams.w6t's (hi, lo), checked against the f32 plane x it will
    meet."""
    w6t = getattr(sp, "w6t", None)
    if w6t is None or len(w6t) != 2:
        raise ValueError("the f32 tensor-core Winograd layer needs "
                         "prep_params' f32 StackParams.w6t")
    for t in w6t:
        if (tuple(t.shape) != (32, 16, 128, 4) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"w6t must be two contiguous f32 "
                             f"[32, 16, 128, 4] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return w6t


def _check_even(y: torch.Tensor, fn: str) -> None:
    h, w = y.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"{fn} needs even dims, got {h}x{w}")


def _check_uvp(uvp: torch.Tensor, ylow: torch.Tensor) -> None:
    if tuple(uvp.shape) != (*ylow.shape, 8):
        raise ValueError(f"uvp must be {(*ylow.shape, 8)} for ylow "
                         f"{tuple(ylow.shape)}, got {tuple(uvp.shape)}")
    if uvp.dtype != torch.float32:
        raise TypeError(f"uvp must be float32, got {uvp.dtype}")
    if uvp.device != ylow.device:
        raise ValueError(f"uvp on {uvp.device}, ylow on {ylow.device}")
    if not uvp.is_contiguous():
        raise ValueError("uvp must be contiguous")


def _dense_tc(wl: int, tc) -> int:
    """The dense chunk width: the caller's, or the low-res width rounded up
    to a warp's 32 columns, at most DENSE_TC."""
    if tc is None:
        return min(DENSE_TC, 32 * -(-wl // 32))
    if tc <= 0 or tc % 32:
        raise ValueError(f"tc must be a positive multiple of 32, got {tc}")
    return tc


def _edge_extend(y: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[N, h, w] -> [N, rows, cols] (rows >= h, cols >= w), the last row
    and column repeated: the JAX package's edge pad to its tile grid."""
    n, h, w = y.shape
    if (rows, cols) == (h, w):
        return y
    r = torch.arange(rows, device=y.device).clamp_(max=h - 1)
    c = torch.arange(cols, device=y.device).clamp_(max=w - 1)
    return y[:, r][:, :, c].contiguous()


def _on_grid(x: torch.Tensor, full_res: bool, form: str, tile):
    """The plane a stack call computes on -> (plane, hl, wl, tiling): x
    itself and no tiling, or with form "i8" x edge-extended to the int8
    tile grid and its (tr, tc, ny, nx). hl x wl are the s2d cells of x, the
    low-res plane [N, hl, wl] or with full_res the full-res plane
    [N, h, w]."""
    _, ph, pw = x.shape
    hl, wl = (-(-ph // 2), -(-pw // 2)) if full_res else (ph, pw)
    tiling = _tiling(hl, wl, form, tile)
    if tiling is not None:
        rows, cols = tiling[0] * tiling[2], tiling[1] * tiling[3]
        x = (_edge_extend(x, 2 * rows, 2 * cols) if full_res
             else _edge_extend(x, rows, cols))
    return x, hl, wl, tiling


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _plain_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype,
                 round_out: bool = True) -> torch.Tensor:
    """F.conv2d + bias + LeakyReLU on f32 values [N, ci, H, W], rounded to
    `dtype` where the kernel rounds what it stores."""
    ci, _, co = w.shape
    w_oihw = w.float().reshape(ci, 3, 3, co).permute(3, 0, 1, 2)
    x = leaky_relu(F.conv2d(x, w_oihw, b))
    return x.to(dtype).float() if round_out else x


def _l1_values(x: torch.Tensor, sp, full_res: bool = False) -> torch.Tensor:
    """Layer 1 (csrc/l1.cu) as f32 values rounded where the kernel rounds:
    x [N, ph, pw] -> x1 [N, 2hg+12, 2wg+12, 32] NHWC. Scale (x the low-res
    plane, hg = ph): phase (A, B) of s2d cell (K, J) is the sum over
    (r, s) = (0,0), (0,1), (1,0), (1,1) of pad4(x)[K+A+r, J+B+s] *
    w1s[(A+r)*3 + (B+s), (A*2+B)*32 + c], pad4 the plane edge-padded by 4
    (each position its own clamp). Noise (x the full-res plane, hg =
    ceil(ph/2)): the taps t = 0..8 of w1 over the plane clamped to its
    raw size, as the index y[clamp(Y-7, 0, ph-1), clamp(X-7, 0, pw-1)].
    Each sum in f32 from the bias, in that order, then LeakyReLU and one
    rounding to x's dtype."""
    n, ph, pw = x.shape
    b1 = sp[0][1]
    if full_res:
        hg, wg = -(-ph // 2), -(-pw // 2)
        r = (torch.arange(2 * hg + 14, device=x.device) - 7).clamp_(0, ph - 1)
        c = (torch.arange(2 * wg + 14, device=x.device) - 7).clamp_(0, pw - 1)
        v = x[:, r][:, :, c].float()[..., None]
        w = sp[0][0].float()[0]                               # [9, 32]
        h1, w1 = 2 * hg + 12, 2 * wg + 12
        acc = b1
        for t in range(9):
            acc = acc + v[:, t // 3:t // 3 + h1, t % 3:t % 3 + w1] * w[t]
    else:
        yp = _lowres_window(x, 0, 0, ph + 8, pw + 8).float()[..., None]
        w = _w1s(sp, x).float()
        phases = []
        for q in range(4):
            a, b = divmod(q, 2)
            acc = b1
            for rs in range(4):
                r, s = divmod(rs, 2)
                acc = acc + (yp[:, a + r:a + r + ph + 6, b + s:b + s + pw + 6]
                             * w[(a + r) * 3 + b + s, q * 32:(q + 1) * 32])
            phases.append(acc)
        acc = (torch.stack(phases, dim=3).reshape(n, ph + 6, pw + 6, 2, 2, 32)
               .permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * ph + 12,
                                                  2 * pw + 12, 32))
    return leaky_relu(acc).to(x.dtype).float()


def l1_plain(x: torch.Tensor, sp, full_res: bool = False) -> torch.Tensor:
    """Plain PyTorch version of layer 1 (l1_layer): x [N, ph, pw] -> x1
    [N, 2hg+12, 2wg+12, 32] NHWC in x's dtype (_l1_values)."""
    return _l1_values(x, sp, full_res).to(x.dtype)


def zs_index(n_out: int, k: int, device=None) -> torch.Tensor:
    """The positions that tap k (0..2) of output positions 0..n_out-1 reads
    on an axis whose shifts are zeroed: r(p, k) = (p & ~1) | ((p + k) & 1),
    the output's own s2d cell (index 0 of every plane is a cell boundary),
    in place of p + k."""
    p = torch.arange(n_out, device=device)
    return (p & ~1) | ((p + k) & 1)


def _tap_view(x: torch.Tensor, dy: int, dx: int, hout: int, wout: int,
              zs: int) -> torch.Tensor:
    """[N, hout, wout, C] of the NHWC x that tap (dy, dx) reads: a slice, or
    on each axis that the zero-shift mask zs zeroes (bit 0 columns, bit 1
    rows) the positions zs_index gives."""
    rows = (zs_index(hout, dy, x.device) if zs & 2
            else slice(dy, dy + hout))
    cols = (zs_index(wout, dx, x.device) if zs & 1
            else slice(dx, dx + wout))
    return x[:, rows][:, :, cols]


def mma_layer_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                    zs: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core layer (mma_layer), from the
    PACKED weights: x [N, hin, win, ci] NHWC, wp [ci/8, 9, co, 8]
    (pack_mma), b [co] f32 -> [N, hin-2, win-2, co] in x's dtype. The 9 taps
    are 9 shifted [pixels, ci] x [ci, co] products summed in f32, then the
    bias, LeakyReLU and the one rounding to x's dtype. zs, the zero-shift
    mask (1 columns, 2 rows, 3 both), remaps each tap's positions on the
    zeroed axes (_tap_view)."""
    w = unpack_mma(wp).float()
    hout, wout = x.shape[1] - 2, x.shape[2] - 2
    xf = x.float()
    acc = None
    with no_tf32():
        for t in range(9):
            term = _tap_view(xf, t // 3, t % 3, hout, wout, zs) @ w[t]
            acc = term if acc is None else acc.add_(term)
    return leaky_relu(acc.add_(b)).to(x.dtype)


def _last_layer_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    zs: int = 0) -> torch.Tensor:
    """last_layer_plain's Y before its rounding, f32 [N, hl, wl, 4]."""
    hout, wout = x.shape[1] - 2, x.shape[2] - 2
    xf, wf = x.float(), w.float()[:, :, 0]
    acc = None
    with no_tf32():
        for t in range(9):
            term = _tap_view(xf, t // 3, t % 3, hout, wout, zs) @ wf[:, t]
            acc = term if acc is None else acc.add_(term)
    return s2d(leaky_relu(acc.add_(b))[..., None])


def last_layer_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     zs: int = 0) -> torch.Tensor:
    """Layer 7 in s2d layout as nine taps summed per pixel, the function the
    fold (l7_fold_plain) computes in another order, on the stored layer-6
    plane: x [N, 2hl+2, 2wl+2, 128] NHWC, w [128, 9, 1], b [1] f32 ->
    [N, hl, wl, 4] in x's dtype: the 9 taps summed in f32, bias, LeakyReLU,
    one rounding; zs as in mma_layer_plain."""
    return _last_layer_f32(x, w, b, zs).to(x.dtype)


def l7_fold_plain(x6: torch.Tensor, w7f: torch.Tensor, b, zs: int = 0,
                  taps: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the folded layer 7 (csrc/l7.cu) on the
    stored layer-6 plane: x6 [N, 2hl+2, 2wl+2, 128] NHWC, w7f [512, 16]
    (pack_l7_fold), b [1] f32 -> Y f32 [N, hl, wl, 4], not rounded. Zt is
    one f32 product of x6's s2d cells [N, hl+1, wl+1, 512] and w7f, TF32
    off; Y the four shifted 4-lane slices Zt[i + Dy*fy, j + Dx*fx, 4s:4s+4]
    (s = 2Dy + Dx) added in the order s = 0, 1, 2, 3, then the bias and
    LeakyReLU. fy = fx = 1, or under the zero-shift mask zs (bit 0 columns,
    bit 1 rows) 0 on each zeroed axis: last_layer_plain(zs)'s function.
    taps=True gives the tap forms instead: Zt[i, j, 0:4] alone, no
    shift-sum, bias (b is not read) or LeakyReLU: the same-cell taps with
    w7f, and with pack_l7_ptaps' weight the unfolded taps 0-3 of the cell's
    pixel (0, 0), whose products involve that pixel alone (only its 128
    rows of the weight are not zero; the kernel reads only those)."""
    if zs not in range(4) or (zs and taps):
        raise ValueError(f"zs must be 0..3, and 0 for the taps; got {zs!r}")
    n, h6, w6, c = x6.shape
    hl, wl = (h6 - 2) // 2, (w6 - 2) // 2
    cells = (x6.float().reshape(n, hl + 1, 2, wl + 1, 2, c)
             .permute(0, 1, 3, 2, 4, 5).reshape(n, hl + 1, wl + 1, 4 * c))
    with no_tf32():
        if taps:
            return cells[:, :hl, :wl] @ w7f.float()[:, 0:4]
        zt = cells @ w7f.float()
    fx, fy = 1 - (zs & 1), 1 - (zs >> 1)
    y = (zt[:, :hl, :wl, 0:4] + zt[:, :hl, fx:fx + wl, 4:8]
         + zt[:, fy:fy + hl, :wl, 8:12] + zt[:, fy:fy + hl, fx:fx + wl, 12:16])
    return leaky_relu(y + b)


def l7_tiles_plain(x6t: torch.Tensor, w7f: torch.Tensor, b,
                   taps: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the folded layer 7 on the int8 layer 6's
    tile-major planes (csrc/l7.cu with a tiling): x6t [N, ny, nx, 2tr+2,
    2tc+2, 128] NHWC -> Y f32 [N, ny*tr, nx*tc, 4], l7_fold_plain of each
    tile (its tap forms with taps=True) placed at its cells of the tile
    grid, not rounded (the caller crops to the image)."""
    n, ny, nx = x6t.shape[:3]
    return _tiles_image(l7_fold_plain(x6t.reshape(-1, *x6t.shape[3:]), w7f,
                                      b, taps=taps), n, ny, nx)


def _tiles_image(y: torch.Tensor, n: int, ny: int, nx: int) -> torch.Tensor:
    """Per-tile cells [n*ny*nx, tr, tc, C] -> the tile grid's cells
    [n, ny*tr, nx*tc, C]."""
    _, tr, tc, c = y.shape
    return (y.reshape(n, ny, nx, tr, tc, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, ny * tr, nx * tc, c))


def last_out(y: torch.Tensor, out: str, dtype, uvp=None, tc=None):
    """Layer 7's f32 Y [N, hl, wl, 4] in the output form `out`: "s2d" Y
    rounded to `dtype`; "dense" the same phase-chunked, (ydense, tc);
    "u8" the u8 BGR [N, hl, wl, 16] of the colour map on the unrounded Y
    and uvp [N, hl, wl, 8] (u phases 0:4, v phases 4:8)."""
    if out == "s2d":
        return y.to(dtype)
    if out == "dense":
        tc = _dense_tc(y.shape[2], tc)
        return s2d_to_dense(y.to(dtype), tc), tc
    chans = combine_u8_cmajor(y, uvp[..., 0:4], uvp[..., 4:8])
    return torch.cat(chans + [torch.zeros_like(chans[0])], dim=-1)


def _plain_mid(x: torch.Tensor, sp, k: int, dtype, mma: bool) -> torch.Tensor:
    """Layer k + 1 (k = 1..5) on f32 values [N, ci, H, W]: _plain_layer, or
    with `mma` mma_layer_plain from the packed weights."""
    if not mma:
        return _plain_layer(x, *sp[k], dtype)
    y = mma_layer_plain(x.permute(0, 2, 3, 1).to(dtype), sp.wm[k - 1],
                        sp[k][1])
    return y.float().permute(0, 3, 1, 2)


def _l6_wino_plain(x5: torch.Tensor, sp, dtype, round_out: bool = True,
                   round_v: bool = False) -> torch.Tensor:
    """Layer 6 as Winograd F(2x2, 3x3) on f32 values [N, 128, H, W] (H, W
    even) -> [N, 128, H-2, W-2]: V from four signed window slices per
    position (rounded to `dtype` with round_v, as the bf16 tensor-core
    kernel rounds it), M[p] = V[p] @ U[p] in f32, Y = A^T M A, bias,
    LeakyReLU, rounded to `dtype` unless round_out is False."""
    n, c, hin, win = x5.shape
    hb, wb = (hin - 2) // 2, (win - 2) // 2
    u, b6 = sp.w6w.float(), sp[5][1]
    xs = x5.permute(0, 2, 3, 1)
    y = [[None, None], [None, None]]
    for py in range(4):
        ms = []
        for px in range(4):
            v = None
            for ty, sy in _WINO_BT_TAPS[py]:
                for tx, sx in _WINO_BT_TAPS[px]:
                    t = xs[:, ty:ty + 2 * hb:2, tx:tx + 2 * wb:2]
                    if v is None:
                        v = t if sy * sx > 0 else -t
                    else:
                        v = v + t if sy * sx > 0 else v - t
            if round_v:
                v = v.to(dtype).float()
            ms.append(v @ u[py * 4 + px])
        nb = (ms[0] + ms[1] + ms[2], ms[1] - ms[2] - ms[3])
        for a in (0, 1):
            ca = _WINO_AT[a][py]
            if ca == 0.0:
                continue
            for bb in (0, 1):
                val = nb[bb] if ca > 0 else -nb[bb]
                y[a][bb] = val if y[a][bb] is None else y[a][bb] + val
    out = torch.stack([torch.stack(y[a], dim=3) for a in (0, 1)], dim=2)
    out = leaky_relu(out.reshape(n, 2 * hb, 2 * wb, c) + b6)
    out = out.permute(0, 3, 1, 2)
    return out.to(dtype).float() if round_out else out


# B^T's rows as d[r0] + d[r1] or d[r0] - d[r1] (the sign), in the order
# csrc/wino.cu computes them
_WINO_BT_ROWS = ((0, 2, -1), (1, 2, 1), (2, 1, -1), (1, 3, -1))


def _bt_row(p: int, d: list) -> torch.Tensor:
    """Row p of B^T applied to the four terms d, one f32 add or subtract."""
    r0, r1, sign = _WINO_BT_ROWS[p]
    return d[r0] + d[r1] if sign > 0 else d[r0] - d[r1]


def wino_layer_plain(x5: torch.Tensor, um: torch.Tensor, b: torch.Tensor,
                     round_out: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core Winograd layer 6
    (wino_layer), in that kernel's arithmetic: x5 [N, H5, W5, 128] NHWC
    (H5, W5 even), um [16, 16, 128, 8] (StackParams.w6m), b [128] f32 ->
    [N, H5-2, W5-2, 128] in x5's dtype. Per 2 x 2 output block: t = B^T d
    along the window's rows, then V = t B along its columns, each one f32
    add; V rounded to x5's dtype; R[A][px] = sum over py of A^T[A][py] *
    (V[py, px] @ U[py, px]) in f32; Y[A][0] = (R0 + R1) + R2, Y[A][1] =
    (R1 - R2) - R3; bias, LeakyReLU, one rounding (none, f32 out, with
    round_out False)."""
    n, h5, w5, c = x5.shape
    hb, wb = (h5 - 2) // 2, (w5 - 2) // 2
    xf, u = x5.float(), unpack_w6m(um).float()

    def win(r, col):
        return xf[:, r:r + 2 * hb:2, col:col + 2 * wb:2]

    v = {}
    for py in range(4):
        t = [_bt_row(py, [win(r, col) for r in range(4)]) for col in range(4)]
        for px in range(4):
            v[py, px] = _bt_row(px, t).to(x5.dtype).float()
    out = xf.new_empty((n, hb, 2, wb, 2, c))
    with no_tf32():
        for a in (0, 1):
            r = [None] * 4
            for py in range(4):
                ca = _WINO_AT[a][py]
                if ca == 0.0:
                    continue
                for px in range(4):
                    term = v[py, px] @ u[py * 4 + px]
                    if r[px] is None:
                        r[px] = term if ca > 0 else -term
                    else:
                        r[px] = r[px] + term if ca > 0 else r[px] - term
            out[:, :, a, :, 0] = leaky_relu((r[0] + r[1]) + r[2] + b)
            out[:, :, a, :, 1] = leaky_relu((r[1] - r[2]) - r[3] + b)
    out = out.reshape(n, 2 * hb, 2 * wb, c)
    return out.to(x5.dtype) if round_out else out


def _l6_i8_window_plain(x5w: torch.Tensor, sp, dtype):
    """Layer 6 as int8 on one tile's window, f32 values
    [N, 128, 2tr+4, 2tc+4] -> (x6 [N, 128, 2tr+2, 2tc+2], sx [N]). The
    integer sums run in f64, where they are exact (1152 * 127^2 exceeds
    f32's 2^24), and are rounded to f32 once, as the kernel converts its
    int32 sum. The JAX kernel converts each group's int32 partial (K <= 512)
    and adds those in f32: equal while the total stays under 2^24, else it
    may differ in the last bit."""
    m = x5w.abs().amax(dim=(1, 2, 3))
    sx = torch.clamp(m, min=1e-8) * _INV127
    inv = torch.ones_like(sx) / sx
    q = torch.clamp(torch.round(x5w * inv[:, None, None, None]), -127, 127)
    wq = (unpack_w6q(sp.w6q).double().reshape(128, 3, 3, 128)
          .permute(3, 0, 1, 2))
    acc = F.conv2d(q.double(), wq).float()
    scale = sx[:, None] * sp.w6s[None, :]
    x6 = leaky_relu(acc * scale[:, :, None, None]
                    + sp[5][1][None, :, None, None])
    return x6.to(dtype).float(), sx


def _phase_taps_plain(x6: torch.Tensor, w7: torch.Tensor,
                      dtype) -> torch.Tensor:
    """The unfolded tap partials of each cell's pixel (0, 0) on f32 values
    [N, 128, 2R+2, 2C+2] -> [N, R, C, 4] (stack_scale_upto, upto=6,
    out="phase_taps")."""
    rows, cols = (x6.shape[2] - 2) // 2, (x6.shape[3] - 2) // 2
    win = x6[:, :, 0:2 * rows:2, 0:2 * cols:2]
    return torch.einsum("nchw,ct->nhwt", win,
                        w7.float()[:, 0:4, 0]).to(dtype).float()


def _taps_plain(x6: torch.Tensor, w7: torch.Tensor, dtype) -> torch.Tensor:
    """The same-cell tap partials of layer 7 on f32 values
    [N, 128, 2R+2, 2C+2] -> [N, R, C, 4] (see stack_scale_upto, upto=6)."""
    rows, cols = (x6.shape[2] - 2) // 2, (x6.shape[3] - 2) // 2
    w7 = w7.float()[:, :, 0]                                  # [128, 9]
    out = []
    for a in (0, 1):
        for b in (0, 1):
            acc = 0.0
            for dy in range(2 - a):
                for dx in range(2 - b):
                    win = x6[:, :, a + dy:a + dy + 2 * rows:2,
                             b + dx:b + dx + 2 * cols:2]
                    acc = acc + torch.einsum("nchw,c->nhw", win,
                                             w7[:, dy * 3 + dx])
            out.append(acc)
    return torch.stack(out, dim=-1).to(dtype).float()


def _plain_stack(x1: torch.Tensor, sp, dtype, round_last: bool = True,
                 form: str = "direct", tiling=None, upto=None,
                 mma: bool = False, out: str = "cell"):
    """The stack from layer 1's output x1 [N, 32, 2hg+12, 2wg+12] (f32
    values, _l1_values) -> [N, hg, wg, 4] in s2d layout (f32 values):
    F.conv2d + bias + LeakyReLU per layer in f32 with TF32 off, each stored
    activation rounded to `dtype` where the kernel rounds it.
    round_last=False leaves the last layer's output unrounded, as the u8
    epilogue reads it. `form` is layer
    6's; with "i8", `tiling` = (tr, tc, ny, nx) must cover hg x wg exactly.
    upto (1..6) stops after that layer and gives its 4 values per cell
    (stack_scale_upto), in the form `out`: with "whole" (upto 1..5) the
    layer's whole NHWC plane, with "phase_taps" (upto 6) the unfolded taps;
    at upto 6 the fold's tap forms (l7_fold_plain(taps=True)).
    With `mma`, layers 2-6 are mma_layer_plain from the packed weights
    sp.wm (layer 6 only in its direct form). Layer 7 is the folded tap
    product, as csrc/l7.cu computes it: l7_fold_plain on layer 6's plane,
    l7_tiles_plain on the int8 layer's tile-major planes. With "wino", V is
    rounded where the kernel rounds it (bf16)."""
    hg, wg = (x1.shape[2] - 12) // 2, (x1.shape[3] - 12) // 2
    b7 = sp[6][1]

    def last(x6):
        if upto == 6:
            return _last_taps_plain(x6.permute(0, 2, 3, 1), sp,
                                    out).to(dtype).float()
        if x6.dim() == 6:
            y = l7_tiles_plain(x6, _w7f(sp, x6), b7)
        else:
            y = l7_fold_plain(x6.permute(0, 2, 3, 1), _w7f(sp, x6), b7)
        return y.to(dtype).float() if round_last else y

    x = x1
    with no_tf32():
        for k in range(1, 5 if upto is None else min(upto, 5)):
            x = _plain_mid(x, sp, k, dtype, mma)
        if upto is not None and upto <= 5:
            if out == "whole":
                return x.permute(0, 2, 3, 1)
            return x[:, :4, 0:2 * hg:2, 0:2 * wg:2].permute(0, 2, 3, 1)
        if form == "wino":
            return last(_l6_wino_plain(x, sp, dtype,
                                       round_v=dtype == torch.bfloat16))
        if form != "i8":
            return last(_plain_mid(x, sp, 5, dtype, mma))
        tr, tc, ny, nx = tiling
        # the tile-major planes, layer 7's input; or the taps tile by tile
        taps = upto is not None
        res = x.new_empty((x.shape[0], hg, wg, 4) if taps else
                          (x.shape[0], ny, nx, 2 * tr + 2, 2 * tc + 2, 128))
        for ti in range(ny):
            for tj in range(nx):
                x6, _ = _l6_i8_window_plain(
                    x[:, :, 2 * ti * tr:2 * (ti + 1) * tr + 4,
                      2 * tj * tc:2 * (tj + 1) * tc + 4], sp, dtype)
                if taps:
                    res[:, ti * tr:(ti + 1) * tr,
                        tj * tc:(tj + 1) * tc] = last(x6)
                else:
                    res[:, ti, tj] = x6.permute(0, 2, 3, 1)
        return res if taps else last(res)


def _scale_plain_f32(ylow: torch.Tensor, sp, round_last: bool = True,
                     form: str = "direct", tile=None, upto=None,
                     mma: bool = False, out: str = "cell"):
    """Layer 1 on the low-res plane (edge-extended to the int8 tile grid,
    where there is one; _l1_values), the stack (_plain_stack), cropped ->
    [N, hl, wl, 4] as f32 values (out="whole": the uncropped plane)."""
    ylow, hl, wl, tiling = _on_grid(
        ylow, False, form if upto in (None, 6) else "direct", tile)
    x1 = _l1_values(ylow, sp).permute(0, 3, 1, 2)
    y = _plain_stack(x1, sp, ylow.dtype, round_last, form, tiling, upto, mma,
                     out)
    return y if out == "whole" else y[:, :hl, :wl]


def stack_scale_plain(ylow: torch.Tensor, sp, l6_i8=None, l6_wino=None,
                      tile=None, mma: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the scale kernel; with `mma`, layers 2-6
    from the packed weights (mma_layer_plain)."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form)
    return _scale_plain_f32(ylow, sp, form=form, tile=tile,
                            mma=mma).to(ylow.dtype)


def _lowres_window(ylow: torch.Tensor, dy: int, dx: int, rows: int,
                   cols: int) -> torch.Tensor:
    """[N, rows, cols] of ylow edge-padded by 4, from its pixel (dy, dx)."""
    _, hl, wl = ylow.shape
    r = (torch.arange(rows, device=ylow.device) + dy - 4).clamp_(0, hl - 1)
    c = (torch.arange(cols, device=ylow.device) + dx - 4).clamp_(0, wl - 1)
    return ylow[:, r][:, :, c]


def stack_scale_upto_plain(ylow: torch.Tensor, sp, upto: int, l6_i8=None,
                           l6_wino=None, tile=None,
                           out: str = "cell") -> torch.Tensor:
    """Plain PyTorch version of stack_scale_upto, in each output form."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form if upto == 6 else "direct")
    _check_upto(upto, out)
    if upto == 0:
        _, hl, wl = ylow.shape
        if out == "whole":
            return _lowres_window(ylow, 0, 0, hl + 8, wl + 8)[..., None]
        taps = ((0, 0),) * 4 if out == "lane0" else (
            (0, 0), (0, 1), (0, 2), (1, 0))
        return torch.stack([_lowres_window(ylow, dy, dx, hl, wl)
                            for dy, dx in taps], dim=-1)
    return _scale_plain_f32(ylow, sp, form=form, tile=tile, upto=upto,
                            out=out).to(ylow.dtype)


def s2d_to_dense(y_s2d: torch.Tensor, tc: int) -> torch.Tensor:
    """Y_s2d [N, hl, wl, 4] -> the phase-chunked dense layout
    [N, hl, nx*4*tc] (zeros past wl); the inverse of dense_to_s2d."""
    n, hl, wl, _ = y_s2d.shape
    nx = -(-wl // tc)
    y = F.pad(y_s2d, (0, 0, 0, nx * tc - wl))
    return (y.reshape(n, hl, nx, tc, 4).transpose(3, 4)
            .reshape(n, hl, nx * 4 * tc))


def dense_to_s2d(ydense: torch.Tensor, tc: int, hl: int,
                 wl: int) -> torch.Tensor:
    """Un-chunk stack_scale_dense's output to the s2d layout
    [N, hl, wl, 4]: a reshape, a transpose and a crop."""
    n, hp, wd = ydense.shape
    nx = wd // (4 * tc)
    y4 = (ydense.reshape(n, hp, nx, 4, tc).transpose(3, 4)
          .reshape(n, hp, nx * tc, 4))
    return y4[:, :hl, :wl, :]


def stack_scale_dense_plain(ylow: torch.Tensor, sp, tc=None, l6_i8=None,
                            l6_wino=None, tile=None):
    """Plain PyTorch version of stack_scale_dense -> (ydense, tc)."""
    tc = _dense_tc(ylow.shape[-1], tc)
    y = stack_scale_plain(ylow, sp, l6_i8, l6_wino, tile)
    return s2d_to_dense(y, tc), tc


def combine_u8_cmajor(y: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> list:
    """f32 Y/U/V planes of one shape -> [B, G, R] uint8 planes of that
    shape: yuv_to_bgr and saturate_cast_u8 of ops/color.py, elementwise in
    the f32 order ((y*inv[c,0] + u*inv[c,1]) + v*inv[c,2]) + off[c], then
    * 255, round half to even, clamp to 0..255."""
    inv, off = color._INV, color._INV_OFF
    chans = []
    for c in range(3):
        val = (y * float(inv[c, 0]) + u * float(inv[c, 1])
               + v * float(inv[c, 2]) + float(off[c])) * 255.0
        chans.append(torch.clamp(torch.round(val), 0, 255).to(torch.uint8))
    return chans


def stack_scale_fused_u8_plain(ylow: torch.Tensor, uvp: torch.Tensor, sp,
                               l6_i8=None, l6_wino=None,
                               tile=None) -> torch.Tensor:
    """Plain PyTorch version of stack_scale_fused_u8: the stack with its
    last layer left in f32, then the colour map on Y and uvp."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form)
    _check_uvp(uvp, ylow)
    y = _scale_plain_f32(ylow, sp, round_last=False, form=form, tile=tile)
    chans = combine_u8_cmajor(y, uvp[..., 0:4], uvp[..., 4:8])
    return torch.cat(chans + [torch.zeros_like(chans[0])], dim=-1)


def _noise_plain_s2d(y: torch.Tensor, sp, l6_i8=None, l6_wino=None,
                     tile=None, mma: bool = False) -> torch.Tensor:
    """Plain noise stack on any [N, h, w]: layer 1 on the plane edge-padded
    to even (to the int8 tile grid, where there is one) and by 7
    (_l1_values), the stack, cropped -> [N, ceil(h/2), ceil(w/2), 4]."""
    form = l6_form(l6_i8, l6_wino)
    _check(y, sp, form)
    h, w = y.shape[1:]
    hl, wl = -(-h // 2), -(-w // 2)
    tiling = _tiling(hl, wl, form, tile)
    hg, wg = (hl, wl) if tiling is None else (tiling[0] * tiling[2],
                                              tiling[1] * tiling[3])
    x1 = _l1_values(_edge_extend(y, 2 * hg, 2 * wg), sp, True)
    ys = _plain_stack(x1.permute(0, 3, 1, 2), sp, y.dtype, form=form,
                      tiling=tiling, mma=mma)
    return ys[:, :hl, :wl].to(y.dtype)


def stack_noise_s2d_plain(y: torch.Tensor, sp, l6_i8=None, l6_wino=None,
                          tile=None, mma: bool = False) -> torch.Tensor:
    """Plain PyTorch version of stack_noise_s2d (even dims only)."""
    _check_even(y, "stack_noise_s2d")
    return _noise_plain_s2d(y, sp, l6_i8, l6_wino, tile, mma)


def stack_noise_plain(y: torch.Tensor, sp, l6_i8=None, l6_wino=None,
                      tile=None, mma: bool = False) -> torch.Tensor:
    """Plain PyTorch version of stack_noise (any dims); `mma` as in
    stack_scale_plain."""
    ys = _noise_plain_s2d(y, sp, l6_i8, l6_wino, tile, mma)
    h, w = y.shape[1:]
    return d2s(ys)[:, :h, :w, 0]


def _check_x5(x5: torch.Tensor, sp, tile) -> tuple:
    """Checks of l6_i8_layer's arguments -> (tr, tc, ny, nx)."""
    tr, tc = tile
    if x5.dim() != 4:
        raise ValueError(f"x5 must be [N, H, W, 128], got {tuple(x5.shape)}")
    ny, nx = (x5.shape[1] - 4) // (2 * tr), (x5.shape[2] - 4) // (2 * tc)
    if min(ny, nx) < 1 or tuple(x5.shape[1:]) != (
            2 * ny * tr + 4, 2 * nx * tc + 4, 128):
        raise ValueError(f"x5 must be [N, 2*ny*{tr}+4, 2*nx*{tc}+4, 128], "
                         f"got {tuple(x5.shape)}")
    if x5.dtype not in DTYPES or not x5.is_contiguous():
        raise TypeError(f"x5 must be contiguous float32 or bfloat16, got "
                        f"{x5.dtype}")
    for name in ("w6q", "w6s", "w6i"):
        t = getattr(sp, name, None)
        if t is None or t.device != x5.device:
            raise ValueError(f"StackParams.{name} must be on {x5.device}")
    return tr, tc, ny, nx


def l6_i8_layer_plain(x5: torch.Tensor, sp, tile):
    """Plain PyTorch version of l6_i8_layer."""
    tr, tc, ny, nx = _check_x5(x5, sp, tile)
    n = x5.shape[0]
    x = x5.float().permute(0, 3, 1, 2)
    x6t = x5.new_empty((n, ny, nx, 2 * tr + 2, 2 * tc + 2, 128))
    sx = torch.empty((n, ny, nx), dtype=torch.float32, device=x5.device)
    for ti in range(ny):
        for tj in range(nx):
            x6, sx[:, ti, tj] = _l6_i8_window_plain(
                x[:, :, 2 * ti * tr:2 * (ti + 1) * tr + 4,
                  2 * tj * tc:2 * (tj + 1) * tc + 4], sp, x5.dtype)
            x6t[:, ti, tj] = x6.permute(0, 2, 3, 1)
    return x6t, sx


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = {
    "mma": {"w2x_mma_layer": [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT,
                              _INT, _INT, _INT, _PTR],
            "w2x_mma_chain": [_INT, _PTR, _PTR, _PTR, _INT, _INT, _PTR],
            "w2x_mma_layer_variant": [_INT, _INT, _INT, _INT, _PTR, _PTR,
                                      _PTR, _PTR, _INT, _INT, _INT, _INT,
                                      _PTR],
            "w2x_mma_layer_max": [_INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                                  _INT, _INT, _PTR, _INT, _INT, _INT, _INT,
                                  _PTR]},
    "gather": {"w2x_upto_gather": [_INT, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                   _INT, _INT, _INT, _PTR]},
    "i8": {"w2x_l6_i8_mma": [_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT,
                             _INT, _INT, _INT, _INT, _PTR]},
    "wino": {"w2x_l6_wino_mma": [_INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                                 _INT, _PTR],
             "w2x_l6_wino_tf32": [_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _INT,
                                  _INT, _INT, _PTR]},
    "l7": {"w2x_l7_fold": [_INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                           _INT, _PTR, _FLOATS, _INT, _INT, _INT, _INT, _INT,
                           _INT, _PTR]},
    "l1": {"w2x_l1": [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                      _PTR]},
    "mma_tf32": {"w2x_tf32_layer": [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                    _INT, _INT, _INT, _INT, _PTR],
                 "w2x_tf32_layer_max": [_INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                        _INT, _INT, _INT, _INT, _PTR, _INT,
                                        _INT, _INT, _INT, _PTR]},
    "epi": {"w2x_cunet_epilogue": [_INT, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                                   _INT, _INT, _INT, _PTR]},
}


_LIBS: dict = {}


def _libs() -> dict:
    """The kernel libraries by source name, built together at first use
    and kept for the process; each exports w2x_error_string for its own
    error codes."""
    if not _LIBS:
        libs = dict(zip(_ARGTYPES, _build.load(*_ARGTYPES)))
        for name, fns in _ARGTYPES.items():
            for fn, argtypes in fns.items():
                getattr(libs[name], fn).argtypes = argtypes
                getattr(libs[name], fn).restype = ctypes.c_int
            libs[name].w2x_error_string.argtypes = [ctypes.c_int]
            libs[name].w2x_error_string.restype = ctypes.c_char_p
        _LIBS.update(libs)
    return _LIBS


class _Launcher:
    """One wrapper call's launches on the current stream of `device`: runs
    the C entries, raises on an error code, counts each launch and records
    the caller's timing events. `kind` is the wrapper's KERNEL_LAUNCHES key,
    or None for a launch that is no part of a stack call."""

    def __init__(self, kind: str, x: torch.Tensor, events):
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        self.kind, self.events, self.step = kind, events, 0
        self.libs = _libs()
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.stream = torch.cuda.current_stream(x.device).cuda_stream
        self.mark()

    def mark(self) -> None:
        """Record the next of the caller's events, if any."""
        if self.events is not None:
            self.events[self.step].record()
        self.step += 1

    def run(self, lib: str, fn: str, what: str, l6=None, *args,
            mid=None, wino=None, l7=None, l1=None, i8=None) -> None:
        """Launch one kernel and count it, under L6_LAUNCHES[l6],
        MID_LAUNCHES[mid], WINO_LAUNCHES[wino], L7_LAUNCHES[l7],
        L1_LAUNCHES[l1] and I8_LAUNCHES[i8] too where given."""
        global LAUNCHES
        err = getattr(self.libs[lib], fn)(self.bf16, *args, self.stream)
        if err:
            msg = self.libs[lib].w2x_error_string(err).decode()
            raise RuntimeError(f"stack kernel, {what}: {msg}")
        if self.kind is not None:
            LAUNCHES += 1
            KERNEL_LAUNCHES[self.kind] += 1
        if l6 is not None:
            L6_LAUNCHES[l6] += 1
        if mid is not None:
            MID_LAUNCHES[mid] += 1
        if wino is not None:
            WINO_LAUNCHES[wino] += 1
        if l7 is not None:
            L7_LAUNCHES[l7] += 1
        if l1 is not None:
            L1_LAUNCHES[l1] += 1
        if i8 is not None:
            I8_LAUNCHES[i8] += 1

    def taps(self, x6, sp, y, n, hl, wl, out: str = "cell", tiling=None,
             l6=None) -> None:
        """stack_scale_upto's tap form `out` ("cell" or "phase_taps") from
        the layer-6 plane x6 (tile-major with tiling, as l7_fold) into y
        [n, hl, wl, 4]: the fold's tap form (l7_fold, _OUT_TAPS or
        _OUT_PTAPS). l6 is the launch's L6_LAUNCHES key, if any."""
        mode = _OUT_PTAPS if out == "phase_taps" else _OUT_TAPS
        self.l7_fold(x6, sp, y, n, hl, wl, mode, tiling=tiling, l6=l6)

    def layer(self, k: int, full_res: bool, src, sp, dst, n, ph, pw,
              out_mode=_OUT_S2D, uvp=None, cmap=None, tc=0, zs: int = 0,
              pp: bool = False) -> None:
        """Layer k + 1: layer 1 on csrc/l1.cu; layers 2-6 on the tensor
        cores, a bf16 call's on csrc/mma.cu and an f32 call's as 3xTF32 on
        csrc/mma_tf32.cu; layer 7 folded (csrc/l7.cu, on the tensor cores in
        bf16, FFMA in f32). zs, a zero-shift mask, and pp, two accumulators,
        are the probes' variants of the bf16 tensor-core layers (zs also of
        the folded layer 7 in s2d layout, in either type)."""
        hg, wg = ((ph + 1) // 2, (pw + 1) // 2) if full_res else (ph, pw)
        if zs not in range(4) or (zs or pp) and (
                k == 0 or (k == 6 and pp) or (k < 6 and not self.bf16)):
            raise ValueError(f"layer {k + 1}: no variant zs={zs}, pp={pp} "
                             f"(bf16 layers 2-6; zs 0..3 on layer 7, f32 or "
                             f"bf16)")
        if k == 0:
            self.l1(full_res, src, sp, dst, n, ph, pw)
        elif k == 6:
            self.l7_fold(src, sp, dst, n, hg, wg, out_mode, uvp, cmap, tc,
                         zs=zs)
        else:
            (self.mma_layer if self.bf16 else self.tf32_layer)(
                k, src, sp, dst, n, 2 * hg + 14 - 2 * k, 2 * wg + 14 - 2 * k,
                l6="direct" if k == 5 else None, zs=zs, pp=pp)

    def l1(self, full_res: bool, x, sp, y, n, ph, pw) -> None:
        """Layer 1 from the [n, ph, pw] plane x (low-res, or full-res with
        full_res) into y [n, 2hg+12, 2wg+12, 32] on csrc/l1.cu."""
        w = sp[0][0] if full_res else _w1s(sp, x)
        self.run("l1", "w2x_l1", "layer 1", None, int(full_res),
                 x.data_ptr(), w.data_ptr(), sp[0][1].data_ptr(),
                 y.data_ptr(), n, ph, pw, l1="l1")

    def tf32_layer(self, k: int, src, sp, dst, n, hin, win, l6=None,
                   zs: int = 0, pp: bool = False) -> None:
        """Layer k + 1 (k = 1..5) of an f32 call as 3xTF32 on the tensor
        cores (csrc/mma_tf32.cu) on an [n, hin, win, ci] plane, counted
        under MID_LAUNCHES["mma_tf32"]. It has no zs / pp variant."""
        if zs or pp:
            raise ValueError(f"layer {k + 1}: no variant zs={zs}, pp={pp} "
                             f"of the f32 layers")
        whi, wlo = _wt(sp, src, k)
        self.run("mma_tf32", "w2x_tf32_layer", f"layer {k + 1} (3xTF32)",
                 l6, k, src.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
                 sp[k][1].data_ptr(), dst.data_ptr(), n, hin, win,
                 tf32_plan(*WIDTHS[k]).smem_bytes, mid="mma_tf32")

    def l7_fold(self, x6, sp, y, n, hl, wl, out_mode=_OUT_S2D, uvp=None,
                cmap=None, tc=0, tiling=None, zs: int = 0, l6=None) -> None:
        """Layer 7 folded (csrc/l7.cu) from the [n, 2hl+2, 2wl+2, 128]
        plane x6, or with tiling = (tr, tc, ny, nx) from the int8 layer's
        tile-major x6 [n, ny, nx, 2tr+2, 2tc+2, 128] cropped to hl x wl, into
        y in the form out_mode (tc: the dense chunk; _OUT_TAPS and
        _OUT_PTAPS the truncation's tap forms): bf16 on the tensor cores
        from StackParams.w7f (w7p for _OUT_PTAPS), f32 with FFMA from w7's
        taps [128, 9] (w7f's entries that are not zero). zs, a zero-shift
        mask, applies to s2d output on a plane only; l6 is the launch's
        L6_LAUNCHES key, if any."""
        if zs and (out_mode != _OUT_S2D or tiling is not None):
            raise ValueError(f"the folded layer 7 takes a zero-shift mask "
                             f"(zs={zs}) on a plane in s2d layout only")
        w = (_w7f(sp, x6, out_mode == _OUT_PTAPS) if self.bf16
             else sp[6][0])
        self.run("l7", "w2x_l7_fold",
                 f"layer 7 (fold{'' if self.bf16 else ', f32'})", l6,
                 x6.data_ptr(), w.data_ptr(), sp[6][1].data_ptr(),
                 y.data_ptr(), n, hl, wl, out_mode,
                 None if uvp is None else uvp.data_ptr(), cmap, tc,
                 *(tiling or (0, 0, 0, 0)), zs,
                 l7="fold" if self.bf16 else "fold_f32")
        if out_mode in (_OUT_TAPS, _OUT_PTAPS):
            TAP_LAUNCHES["ptaps" if out_mode == _OUT_PTAPS else "taps"] += 1

    def mma_layer(self, k: int, src, sp, dst, n, hin, win, l6=None,
                  zs: int = 0, pp: bool = False,
                  persistent: bool = True) -> None:
        """Layer k + 1 (k = 1..5) of csrc/mma.cu on an [n, hin, win, ci]
        plane: the persistent kernel (w2x_mma_layer, counted under
        MID_LAUNCHES "mma" and its route), with persistent=False the tile
        kernel (w2x_mma_layer_variant at zs 0, "mma" and "mma_tile"); with
        zs or pp the tile kernel's probe variant (counted under "mma_zs" or
        "mma_pp")."""
        wm = getattr(sp, "wm", None)
        if wm is None:
            raise ValueError("the tensor-core layers need prep_params' "
                             "packed weights (StackParams.wm)")
        if persistent and not (zs or pp):
            self.mma(src, wm[k - 1], sp[k][1], dst, n, hin, win,
                     f"layer {k + 1} (mma)", l6)
            return
        plan = mma_plan(*WIDTHS[k], zs, pp, persistent)
        args = (src.data_ptr(), wm[k - 1].data_ptr(), sp[k][1].data_ptr(),
                dst.data_ptr(), n, hin, win, plan.smem_bytes)
        if zs or pp:
            self.run("mma", "w2x_mma_layer_variant",
                     f"layer {k + 1} (mma, zs {zs}, pp {int(pp)})", l6, k, zs,
                     int(pp), *args, mid="mma_pp" if pp else "mma_zs")
            return
        self.run("mma", "w2x_mma_layer_variant",
                 f"layer {k + 1} (mma, tile kernel)", l6, k, 0, 0, *args,
                 mid="mma")
        self._route(*WIDTHS[k], plan.route)

    def mma(self, src, wp, b, dst, n, hin, win, what: str, l6=None) -> str:
        """A ci -> co layer on csrc/mma.cu's persistent kernel, its entry
        keyed by the widths of wp = pack_mma(w) [ci/8, 9, co, 8]: src [n,
        hin, win, ci] -> dst [n, hin-2, win-2, co], bias b [co] f32. Counted
        under MID_LAUNCHES "mma" and the plan's route, and MMA_SHAPES.
        Returns the route."""
        ci, co = wp.shape[0] * 8, wp.shape[2]
        plan = mma_plan(ci, co)
        self.run("mma", "w2x_mma_layer", what, l6, ci, co, src.data_ptr(),
                 wp.data_ptr(), b.data_ptr(), dst.data_ptr(), n, hin, win,
                 plan.smem_bytes, mid="mma")
        self._route(ci, co, plan.route)
        return plan.route

    @staticmethod
    def _route(ci: int, co: int, route: str) -> None:
        MID_LAUNCHES["mma_" + route] += 1
        key = (ci, co, route)
        MMA_SHAPES[key] = MMA_SHAPES.get(key, 0) + 1

    def wino(self, x5, sp, y6, n, h5, w5, l6=None) -> None:
        """Layer 6 as Winograd on an [n, h5, w5, 128] plane on the tensor
        cores (csrc/wino.cu; bf16 from w6m, f32 as 3xTF32 from w6t)."""
        if self.bf16:
            w6m = getattr(sp, "w6m", None)
            if w6m is None or w6m.dtype != x5.dtype or (
                    w6m.device != x5.device) or not w6m.is_contiguous():
                raise ValueError("the tensor-core Winograd layer needs "
                                 "prep_params' StackParams.w6m, contiguous, "
                                 f"{x5.dtype} on {x5.device}")
            self.run("wino", "w2x_l6_wino_mma", "layer 6, Winograd (mma)",
                     l6, x5.data_ptr(), w6m.data_ptr(), sp[5][1].data_ptr(),
                     y6.data_ptr(), n, h5, w5, wino="mma")
            return
        uhi, ulo = _w6t(sp, x5)
        self.run("wino", "w2x_l6_wino_tf32", "layer 6, Winograd (3xTF32)",
                 l6, x5.data_ptr(), uhi.data_ptr(), ulo.data_ptr(),
                 sp[5][1].data_ptr(), y6.data_ptr(), n, h5, w5,
                 wino="mma_tf32")

    def layer5_max(self, src, sp, dst, n, hin, win, m, tiling) -> None:
        """Layer 5 on the [n, hin, win, 64] plane src into dst with B4's
        tile maxima in its epilogue: m [n, ny, nx] f32 (zeros) gets max |x5|
        of each tile window of tiling = (tr, tc, ny, nx). bf16 on csrc/
        mma.cu, f32 as 3xTF32 on csrc/mma_tf32.cu; counted under
        MID_LAUNCHES and I8_LAUNCHES["l5max"]."""
        tile_args = (m.data_ptr(), *tiling)
        if self.bf16:
            wm = getattr(sp, "wm", None)
            if wm is None:
                raise ValueError("the tensor-core layers need prep_params' "
                                 "packed weights (StackParams.wm)")
            self.run("mma", "w2x_mma_layer_max", "layer 5 (mma, tile maxima)",
                     None, src.data_ptr(), wm[3].data_ptr(),
                     sp[4][1].data_ptr(), dst.data_ptr(), n, hin, win,
                     mma_plan(*WIDTHS[4], persistent=False).smem_bytes,
                     *tile_args, mid="mma", i8="l5max")
            MID_LAUNCHES["mma_tile"] += 1
            return
        whi, wlo = _wt(sp, src, 4)
        self.run("mma_tf32", "w2x_tf32_layer_max",
                 "layer 5 (3xTF32, tile maxima)", None, src.data_ptr(),
                 whi.data_ptr(), wlo.data_ptr(), sp[4][1].data_ptr(),
                 dst.data_ptr(), n, hin, win,
                 tf32_plan(*WIDTHS[4]).smem_bytes, *tile_args,
                 mid="mma_tf32", i8="l5max")

    def gather(self, src, out, n, hl, wl, hk, wk, ck, mode: int) -> None:
        """stack_scale_upto's gather at upto 0..5 (csrc/gather.cu)."""
        self.run("gather", "w2x_upto_gather", f"upto gather, mode {mode}",
                 "upto", src.data_ptr(), out.data_ptr(), n, hl, wl, hk, wk,
                 ck, mode)
        GATHER_LAUNCHES["tiled"] += 1

    def l6_i8(self, x5, sp, n, tiling, m) -> torch.Tensor:
        """The int8 layer 6 on the tensor cores (csrc/i8.cu) from the tile
        maxima m [n, ny, nx] f32 that layer 5's epilogue took -> x6t,
        tile-major."""
        tr, tc, ny, nx = tiling
        w6i = getattr(sp, "w6i", None)
        if w6i is None or tuple(w6i.shape) != (8, 9, 128, 16) or (
                w6i.dtype != torch.int8 or w6i.device != x5.device
                or not w6i.is_contiguous()):
            raise ValueError("the int8 tensor-core layer needs prep_params' "
                             f"StackParams.w6i, contiguous int8 on "
                             f"{x5.device}")
        x6t = torch.empty((n, ny, nx, 2 * tr + 2, 2 * tc + 2, 128),
                          dtype=x5.dtype, device=x5.device)
        self.run("i8", "w2x_l6_i8_mma", "layer 6, int8 (mma)", "i8",
                 x5.data_ptr(), w6i.data_ptr(), sp.w6s.data_ptr(),
                 sp[5][1].data_ptr(), m.data_ptr(), x6t.data_ptr(), n, tr,
                 tc, ny, nx, i8="mma")
        return x6t


def _last_buffer(out_mode: int, x: torch.Tensor, n: int, hl: int, wl: int,
                 tc: int):
    """The last layer's output for out_mode on x's device -> (y, cmap): Y
    in x's dtype, [n, hl, wl, 4] or dense [n, hl, ceil(wl/tc)*4*tc], or u8
    [n, hl, wl, 16] with the colour map as the C entry takes it (cmap[12]:
    the YUV -> BGR matrix row by row, then its offsets; None otherwise)."""
    if out_mode == _OUT_DENSE:
        return torch.empty((n, hl, -(-wl // tc) * 4 * tc), dtype=x.dtype,
                           device=x.device), None
    if out_mode == _OUT_U8:
        cmap = (ctypes.c_float * 12)(*color._INV.ravel().tolist(),
                                     *color._INV_OFF.tolist())
        return torch.empty((n, hl, wl, 16), dtype=torch.uint8,
                           device=x.device), cmap
    return torch.empty((n, hl, wl, 4), dtype=x.dtype, device=x.device), None


def _launch(x: torch.Tensor, sp, kind: str, events, uvp=None, tc: int = 0,
            form: str = "direct", tile=None, upto=None,
            out_form: str = "cell") -> torch.Tensor:
    """One call's launches on the current stream, no synchronisation: x is
    the low-res plane [N, hl, wl] (kinds "scale", "dense", "fused_u8") or
    the full-res plane [N, h, w] ("noise": any size, computed on the
    even-rounded plane, hl = ceil(h/2)). The last layer writes Y_s2d
    [N, hl, wl, 4], or for "dense" Y [N, hl, nx*4*tc], or for "fused_u8"
    u8 BGR [N, hl, wl, 16] from `uvp`; with `upto` (0..6) the stack stops
    after that layer and its 4 values per cell are written instead, or the
    other form `out_form` of stack_scale_upto (at upto 6 on the fold).
    `form` is layer 6's; "i8" runs on the plane edge-extended to the tile
    grid, and there layer 5 also takes the tile maxima. `events`, a list of
    timing-enabled CUDA events, is recorded before the first launch and
    after each layer's launches (8 events for a whole stack, upto + 2 with
    `upto`)."""
    m = None   # B4's tile maxima, zeros for layer 5's atomicMax
    full_res = kind == "noise"
    x, hl, wl, tiling = _on_grid(
        x, full_res, form if upto in (None, 6) else "direct", tile)
    n, ph, pw = x.shape
    # the s2d cells of the plane the layers run on
    hg, wg = ((ph + 1) // 2, (pw + 1) // 2) if full_res else (ph, pw)
    act = n * (2 * hg + 12) * (2 * wg + 12) * 128   # layer 1-6 outputs fit
    out_mode, cmap = _OUT_MODES[kind], None
    with torch.cuda.device(x.device):
        run = _Launcher(kind, x, events)
        bufs = [torch.empty(act, dtype=x.dtype, device=x.device)
                for _ in range(0 if upto == 0 else 2)]
        # every element of each output form is written by the last launch
        if out_form == "whole":   # at upto >= 1, layer upto's buffer itself
            out = (torch.empty((n, hl + 8, wl + 8, 1), dtype=x.dtype,
                               device=x.device) if upto == 0 else None)
        else:
            out, cmap = _last_buffer(out_mode, x, n, hl, wl, tc)
        src = x
        for k in range(5 if upto is None else min(upto, 5)):
            if k == 4 and tiling is not None:
                m = torch.zeros((n, *tiling[2:]), dtype=torch.float32,
                                device=x.device)
                run.layer5_max(src, sp, bufs[0], n, 2 * hg + 6, 2 * wg + 6,
                               m, tiling)
            else:
                run.layer(k, full_res, src, sp, bufs[k % 2], n, ph, pw)
            run.mark()
            src = bufs[k % 2]
        if upto is not None and upto <= 5:
            hk = 2 * hl + 14 - 2 * upto      # layer `upto`'s output plane
            wk, ck = 2 * wl + 14 - 2 * upto, WIDTHS[upto - 1][1] if upto else 1
            if out is None:
                return src[:n * hk * wk * ck].view(n, hk, wk, ck)
            run.gather(src, out, n, hl, wl, hk, wk, ck,
                       _GATHER_LOWRES[out_form] if upto == 0 else 0)
            run.mark()
            return out
        # layer 6 in its form, layer 5's output being in bufs[0]
        if form == "i8":
            x6 = run.l6_i8(src, sp, n, tiling, m)
        elif form == "wino":
            x6 = bufs[1]
            run.wino(src, sp, x6, n, 2 * hg + 4, 2 * wg + 4, "wino")
        else:
            x6 = bufs[1]
            run.layer(5, full_res, src, sp, x6, n, ph, pw)
        run.mark()
        if form != "i8" and upto is None:
            run.layer(6, full_res, x6, sp, out, n, ph, pw, out_mode, uvp,
                      cmap, tc)
        elif upto is None:   # folded, from the tile-major layer 6
            run.l7_fold(x6, sp, out, n, hl, wl, out_mode, uvp, cmap, tc,
                        tiling)
        else:   # the tap forms, folded
            run.taps(x6, sp, out, n, hl, wl, out_form, tiling, "upto")
        run.mark()
    return out


def l6_i8_layer(x5: torch.Tensor, sp, tile, m=None):
    """The int8 layer 6 alone: the stored layer-5 activation x5
    [N, 2*ny*tr + 4, 2*nx*tc + 4, 128] (NHWC, f32 or bf16, contiguous) of a
    plane that is a whole grid of tile = (tr, tc) cells -> (x6t
    [N, ny, nx, 2tr+2, 2tc+2, 128] in x5's dtype: each tile's layer-6
    activation with its one-pixel halo, quantised with that tile's scale;
    sx [N, ny, nx] f32: the tiles' activation scales). m is the tiles' max
    |x5| [N, ny, nx] f32 as layer5_maxima gives them, as the stacks take
    them from layer 5's epilogue. CPU tensors take the plain version, which
    takes the maxima itself (m may be None); CUDA tensors need m and take
    csrc/i8.cu on the int8 tensor cores, whose launch counts under
    L6_LAUNCHES["i8"] and I8_LAUNCHES only."""
    tiling = _check_x5(x5, sp, tile)
    if m is not None and (tuple(m.shape) != (x5.shape[0], *tiling[2:])
                          or m.dtype != torch.float32
                          or m.device != x5.device):
        raise ValueError(f"m must be f32 [N, ny, nx] = "
                         f"{(x5.shape[0], *tiling[2:])} on {x5.device}")
    if x5.device.type == "cpu":
        return l6_i8_layer_plain(x5, sp, tile)
    if m is None:
        raise ValueError("on the card l6_i8_layer needs the tile maxima m "
                         "(layer5_maxima)")
    m = m.contiguous()
    with torch.cuda.device(x5.device):
        x6t = _Launcher(None, x5, None).l6_i8(x5, sp, x5.shape[0], tiling, m)
    return x6t, torch.clamp(m, min=1e-8) * _INV127


def tile_max_plain(x5: torch.Tensor, tile) -> torch.Tensor:
    """Plain version of B4's tile maxima: x5 [N, 2*ny*tr + 4,
    2*nx*tc + 4, C] -> m [N, ny, nx] f32, max |x5| over each tile window
    (rows [2 ti tr, 2 ti tr + 2tr + 4), columns likewise). A NaN counts as
    0, as the kernels' fmaxf drops it."""
    tr, tc = tile
    ny, nx = (x5.shape[1] - 4) // (2 * tr), (x5.shape[2] - 4) // (2 * tc)
    a = x5.float().abs()
    a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    m = torch.empty((x5.shape[0], ny, nx), dtype=torch.float32,
                    device=x5.device)
    for ti in range(ny):
        for tj in range(nx):
            m[:, ti, tj] = a[:, 2 * ti * tr:2 * (ti + 1) * tr + 4,
                             2 * tj * tc:2 * (tj + 1) * tc + 4].amax(
                                 dim=(1, 2, 3))
    return m


def _check_x4(x4: torch.Tensor, sp, tile) -> tuple:
    """Checks of layer5_maxima's arguments -> (tr, tc, ny, nx)."""
    tr, tc = tile
    if x4.dim() != 4:
        raise ValueError(f"x4 must be [N, H, W, 64], got {tuple(x4.shape)}")
    ny, nx = (x4.shape[1] - 6) // (2 * tr), (x4.shape[2] - 6) // (2 * tc)
    if min(ny, nx) < 1 or tuple(x4.shape[1:]) != (
            2 * ny * tr + 6, 2 * nx * tc + 6, 64):
        raise ValueError(f"x4 must be [N, 2*ny*{tr}+6, 2*nx*{tc}+6, 64], "
                         f"got {tuple(x4.shape)}")
    if x4.dtype not in DTYPES or not x4.is_contiguous():
        raise TypeError(f"x4 must be contiguous float32 or bfloat16, got "
                        f"{x4.dtype}")
    wm = getattr(sp, "wm", None)
    if wm is None:
        raise ValueError("layer5_maxima needs prep_params' packed weights "
                         "(StackParams.wm)")
    _check_wm(wm, x4)
    return tr, tc, ny, nx


def layer5_maxima_plain(x4: torch.Tensor, sp, tile):
    """Plain version of layer5_maxima -> (x5, m): layer 5 as
    mma_layer_plain computes it, and tile_max_plain of that x5."""
    _check_x4(x4, sp, tile)
    x5 = mma_layer_plain(x4, sp.wm[3], sp[4][1])
    return x5, tile_max_plain(x5, tile)


def layer5_maxima(x4: torch.Tensor, sp, tile):
    """Layer 5 alone with B4's tile maxima in its epilogue: x4, layer 4's
    output [N, 2*ny*tr + 6, 2*nx*tc + 6, 64] of a plane that is a whole grid
    of tile = (tr, tc) cells (NHWC, contiguous) -> (x5 [N, 2*ny*tr + 4,
    2*nx*tc + 4, 128] in x4's dtype, as mma_layer(x4, sp, 5) computes it;
    m [N, ny, nx] f32, max |x5| over each tile window, as tile_max_plain(x5)
    gives it). CPU tensors take the plain version; CUDA tensors the
    layer-5 kernel's instance with the maxima (bf16 csrc/mma.cu, f32
    csrc/mma_tf32.cu), counted under MID_LAUNCHES and I8_LAUNCHES["l5max"]
    only."""
    tiling = _check_x4(x4, sp, tile)
    if x4.device.type == "cpu":
        return layer5_maxima_plain(x4, sp, tile)
    n, hin, win, _ = x4.shape
    with torch.cuda.device(x4.device):
        x5 = torch.empty((n, hin - 2, win - 2, 128), dtype=x4.dtype,
                         device=x4.device)
        m = torch.zeros((n, *tiling[2:]), dtype=torch.float32,
                        device=x4.device)
        _Launcher(None, x4, None).layer5_max(x4, sp, x5, n, hin, win, m,
                                             tiling)
    return x5, m


def layer5_plane(x: torch.Tensor, sp, tile=None,
                 full_res: bool = False) -> torch.Tensor:
    """What l6_i8_layer reads: the stored output of layers 1-5 on the
    plane x edge-extended to the int8 tile grid, NHWC
    [N, 2*ny*tr + 4, 2*nx*tc + 4, 128] in x's dtype. x is the low-res
    plane [N, hl, wl] of the scale stack, or with full_res the noise
    stack's plane [N, h, w]. CPU tensors take the plain layers; CUDA
    tensors take the kernel's five launches, which count under L1_LAUNCHES
    and MID_LAUNCHES only (no stack ran)."""
    _check(x, sp)
    x, _, _, (tr, tc, ny, nx) = _on_grid(x, full_res, "i8", tile)
    n, hg, wg = x.shape[0], tr * ny, tc * nx
    if x.device.type == "cpu":
        a = _l1_values(x, sp, full_res).permute(0, 3, 1, 2)
        with no_tf32():
            for w, b in sp[1:5]:
                a = _plain_layer(a, w, b, x.dtype)
        return a.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    act = n * (2 * hg + 12) * (2 * wg + 12) * 128
    with torch.cuda.device(x.device):
        run = _Launcher(None, x, None)
        bufs = [torch.empty(act, dtype=x.dtype, device=x.device)
                for _ in range(2)]
        src = x
        for k in range(5):
            run.layer(k, full_res, src, sp, bufs[k % 2], n, *x.shape[1:])
            src = bufs[k % 2]
    return src[:n * (2 * hg + 4) * (2 * wg + 4) * 128].view(
        n, 2 * hg + 4, 2 * wg + 4, 128)


def mma_layer(x: torch.Tensor, sp, k: int, zs: int = 0,
              pp: bool = False, persistent: bool = True) -> torch.Tensor:
    """Layer k (2..6) alone on the tensor cores: x [N, hin, win, ci] NHWC,
    contiguous -> [N, hin-2, win-2, co] in x's dtype, with layer k's bias.
    bf16 takes csrc/mma.cu from sp.wm[k-2]: the persistent kernel, or with
    persistent=False the tile kernel (the same function, the timing
    yardstick); zs (zero-shift mask) and pp (two accumulators, the same
    function) select a probe variant of the tile kernel (mma_plan). f32
    takes the 3xTF32 kernel (csrc/mma_tf32.cu, tf32_plan) from sp.wt[k-2],
    and no variant. CPU tensors take mma_layer_plain (from sp.wm, which for
    f32 storage holds the f32 weights); CUDA tensors take the kernel, whose
    launch counts under MID_LAUNCHES["mma"] and its route ("mma_zs",
    "mma_pp"; "mma_tf32" for f32) only."""
    if k not in range(2, 7):
        raise ValueError(f"the tensor-core kernel runs layers 2..6, got {k}")
    ci, co = WIDTHS[k - 1]
    if x.dtype == torch.float32:
        if zs or pp or not persistent:
            raise ValueError(f"no f32 variant zs={zs!r}, pp={pp!r}, "
                             f"persistent={persistent!r}")
        tf32_plan(ci, co)
    else:
        mma_plan(ci, co, zs, pp)   # raises for a variant that is not built
    if x.dim() != 4 or x.shape[3] != ci or min(x.shape[1:3]) < 3:
        raise ValueError(f"layer {k} takes [N, hin >= 3, win >= 3, {ci}], "
                         f"got {tuple(x.shape)}")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32 or bfloat16, got "
                        f"{x.dtype}")
    wm = getattr(sp, "wm", None)
    if wm is None:
        raise ValueError("mma_layer needs prep_params' packed weights "
                         "(StackParams.wm)")
    _check_wm(wm, x)
    if x.device.type == "cpu":
        return mma_layer_plain(x, wm[k - 2], sp[k - 1][1], zs)
    n, hin, win, _ = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty((n, hin - 2, win - 2, co), dtype=x.dtype,
                        device=x.device)
        run = _Launcher(None, x, None)
        if run.bf16:
            run.mma_layer(k - 1, x, sp, y, n, hin, win, zs=zs, pp=pp,
                          persistent=persistent)
        else:
            run.tf32_layer(k - 1, x, sp, y, n, hin, win)
    return y


def conv3x3_mma(x: torch.Tensor, wp: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """One 3x3 layer + bias + LeakyReLU(0.1) on csrc/mma.cu's persistent
    kernel, keyed by its widths alone: x [N, h, w, ci] bf16 NHWC,
    contiguous, h, w >= 3; wp = pack_mma(w) [ci/8, 9, co, 8] bf16; b [co]
    f32 -> [N, h-2, w-2, co] bf16, f32 sums rounded once. (ci, co) is one
    of the kernel's shapes (has_mma: vgg_7's layers 2-6 and 128 -> 64).
    CPU tensors take mma_layer_plain; CUDA tensors one launch, which is no
    stack call's (like mma_layer alone) and counts under MID_LAUNCHES "mma"
    and its route, and MMA_SHAPES. A "w2x.stack" span (kind "cunet") holds
    the call, with ci, co and the route it took."""
    if x.dim() != 4 or wp.dim() != 4 or wp.shape[1] != 9 or wp.shape[3] != 8:
        raise ValueError(f"conv3x3_mma takes x [N, h, w, ci] and wp [ci/8, "
                         f"9, co, 8], got {tuple(x.shape)}, {tuple(wp.shape)}")
    ci, co = wp.shape[0] * 8, wp.shape[2]
    if not has_mma(ci, co):
        raise ValueError(f"no tensor-core kernel for a {ci} -> {co} layer")
    if x.shape[3] != ci or min(x.shape[1:3]) < 3:
        raise ValueError(f"a {ci} -> {co} layer takes [N, h >= 3, w >= 3, "
                         f"{ci}], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or wp.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_mma runs bf16, got {x.dtype} x {wp.dtype}")
    if not (x.is_contiguous() and wp.is_contiguous()):
        raise ValueError("x and wp must be contiguous")
    if wp.device != x.device or b.device != x.device or tuple(b.shape) != (
            co,):
        raise ValueError(f"wp and b [{co}] must be on {x.device}")
    n, h, w, _ = x.shape
    with trace.span("w2x.stack", on=x, kind="cunet", dtype=x.dtype,
                    shape=x.shape, ci=ci, co=co) as s:
        if x.device.type == "cpu":
            return mma_layer_plain(x, wp, b)
        with torch.cuda.device(x.device):
            y = torch.empty((n, h - 2, w - 2, co), dtype=x.dtype,
                            device=x.device)
            route = _Launcher(None, x, None).mma(
                x, wp, b.float().contiguous(), y, n, h, w,
                f"{ci} -> {co} (mma)")
        s.set(route=route, launches=1)
    return y


def l1_layer(x: torch.Tensor, sp, full_res: bool = False) -> torch.Tensor:
    """Layer 1 alone: x [N, ph, pw] (f32 or bf16, contiguous; the low-res
    plane, or with full_res the noise stack's full-res plane, any size) ->
    x1 [N, 2hg+12, 2wg+12, 32] NHWC in x's dtype, what the stack's layer 2
    reads (hg = ph, or ceil(ph/2) with full_res). The kernel is csrc/l1.cu,
    the stack's. CPU tensors take l1_plain; CUDA tensors take the kernel,
    whose launch counts under L1_LAUNCHES only."""
    _check(x, sp)
    if x.device.type == "cpu":
        return l1_plain(x, sp, full_res)
    n, ph, pw = x.shape
    hg, wg = (-(-ph // 2), -(-pw // 2)) if full_res else (ph, pw)
    with torch.cuda.device(x.device):
        y = torch.empty((n, 2 * hg + 12, 2 * wg + 12, 32), dtype=x.dtype,
                        device=x.device)
        _Launcher(None, x, None).l1(full_res, x, sp, y, n, ph, pw)
    return y


def wino_layer(x5: torch.Tensor, sp) -> torch.Tensor:
    """The Winograd layer 6 alone: x5 [N, H5, W5, 128] NHWC, bf16 or f32,
    contiguous, H5 and W5 even and >= 4 -> [N, H5-2, W5-2, 128] in x5's
    dtype, with layer 6's bias. CUDA tensors take the tensor cores
    (csrc/wino.cu: bf16 from StackParams.w6m, counted under
    WINO_LAUNCHES["mma"]; f32 as 3xTF32 from StackParams.w6t, under
    "mma_tf32") and count nowhere else; CPU tensors take wino_layer_plain
    (from w6m, which for f32 storage holds the f32 U: the f32 function)."""
    if (x5.dim() != 4 or x5.shape[3] != 128 or x5.shape[1] % 2
            or x5.shape[2] % 2 or min(x5.shape[1:3]) < 4):
        raise ValueError(f"x5 must be [N, H5, W5, 128] with H5, W5 even "
                         f"and >= 4, got {tuple(x5.shape)}")
    if x5.dtype not in DTYPES or not x5.is_contiguous():
        raise TypeError(f"x5 must be contiguous float32 or bfloat16, got "
                        f"{x5.dtype}")
    w6m, w6w = getattr(sp, "w6m", None), getattr(sp, "w6w", None)
    if w6m is None or w6w is None or tuple(w6m.shape) != (16, 16, 128, 8):
        raise ValueError("wino_layer needs prep_params' StackParams.w6m "
                         "and w6w")
    if any(t.dtype != x5.dtype or t.device != x5.device
           for t in (w6m, w6w)) or sp[5][1].device != x5.device:
        raise TypeError(f"w6m, w6w and layer 6's bias must be on "
                        f"{x5.device}, the weights {x5.dtype}; got "
                        f"{w6m.dtype} on {w6m.device}")
    if x5.device.type == "cpu":
        return wino_layer_plain(x5, w6m, sp[5][1])
    n, h5, w5, _ = x5.shape
    with torch.cuda.device(x5.device):
        y6 = torch.empty((n, h5 - 2, w5 - 2, 128), dtype=x5.dtype,
                         device=x5.device)
        _Launcher(None, x5, None).wino(x5, sp, y6, n, h5, w5)
    return y6


_LAST_OUTS = {"s2d": _OUT_S2D, "dense": _OUT_DENSE, "u8": _OUT_U8}


def _last_taps_plain(x: torch.Tensor, sp, out: str) -> torch.Tensor:
    """stack_scale_upto's tap form `out` at upto 6 ("cell", the same-cell
    taps, or "phase_taps") as f32 partials [P, hl, wl, 4] on the planes x
    [P, 2hl+2, 2wl+2, 128] NHWC: the fold's (l7_fold_plain(taps=True), from
    w7f or, for "phase_taps", w7p), not rounded."""
    return l7_fold_plain(x, _w7f(sp, x, out == "phase_taps"), None,
                         taps=True)


def last_layer(x: torch.Tensor, sp, zs: int = 0, out: str = "s2d",
               uvp=None, tc=None):
    """Layer 7 alone on the stored layer-6 plane x [N, 2hl+2, 2wl+2, 128]
    NHWC (f32 or bf16, contiguous), in the output form `out` of last_out:
    "s2d" [N, hl, wl, 4] in x's dtype, "dense" (ydense, tc), "u8"
    [N, hl, wl, 16] from uvp [N, hl, wl, 8] f32. The kernel is the stack's:
    the fold (csrc/l7.cu: bf16 on the tensor cores, f32 with FFMA), under
    the zero-shift mask zs too (0..3, s2d only; see l7_fold_plain). CPU
    tensors take its plain version (l7_fold_plain, then last_out); CUDA
    tensors take the kernel, whose launch counts under L7_LAUNCHES only."""
    if zs not in range(4) or (zs and out != "s2d"):
        raise ValueError(f"zs must be 0..3, and 0 for out={out!r}; got "
                         f"{zs!r}")
    if out not in _LAST_OUTS:
        raise ValueError(f"out must be one of {sorted(_LAST_OUTS)}, got "
                         f"{out!r}")
    if (x.dim() != 4 or x.shape[3] != 128 or x.shape[1] % 2
            or x.shape[2] % 2 or min(x.shape[1:3]) < 4):
        raise ValueError(f"x must be [N, 2hl+2, 2wl+2, 128], got "
                         f"{tuple(x.shape)}")
    n, hin, win = x.shape[:3]
    hl, wl = (hin - 2) // 2, (win - 2) // 2
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32 or bfloat16, got "
                        f"{x.dtype}")
    w, b = sp[6]
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"layer 7's weights are {w.dtype} on {w.device}")
    if out == "u8":
        if uvp is None:
            raise ValueError("out='u8' needs uvp [N, hl, wl, 8]")
        _check_uvp(uvp, x[..., :hl, :wl, 0])
    if x.device.type == "cpu":
        return last_out(l7_fold_plain(x, _w7f(sp, x), b, zs), out, x.dtype,
                        uvp, tc)
    tc = _dense_tc(wl, tc) if out == "dense" else 0
    with torch.cuda.device(x.device):
        y, cmap = _last_buffer(_LAST_OUTS[out], x, n, hl, wl, tc)
        _Launcher(None, x, None).layer(
            6, False, x, sp, y, n, hl, wl, _LAST_OUTS[out], uvp, cmap, tc,
            zs=zs)
    return (y, tc) if out == "dense" else y


def last_layer_tiles(x6t: torch.Tensor, sp, hl: int, wl: int,
                     out: str = "s2d", uvp=None, tc=None):
    """Layer 7 alone on the int8 layer 6's tile-major planes x6t [N, ny, nx,
    2tr+2, 2tc+2, 128] NHWC (f32 or bf16, contiguous: what l6_i8_layer
    returns), each tile's Y at its cells of the image, cropped to hl x wl
    (ny*tr >= hl > (ny-1)*tr, likewise wl), in the output form `out` of
    last_out ("dense" with the chunk tc). The kernel is the int8 stacks':
    the fold (csrc/l7.cu). CPU tensors take its plain version
    (l7_tiles_plain, then last_out); CUDA tensors take the kernel, whose
    launch counts under L7_LAUNCHES only."""
    if out not in _LAST_OUTS:
        raise ValueError(f"out must be one of {sorted(_LAST_OUTS)}, got "
                         f"{out!r}")
    if (x6t.dim() != 6 or x6t.shape[5] != 128 or x6t.shape[3] % 2
            or x6t.shape[4] % 2 or min(x6t.shape[3:5]) < 4):
        raise ValueError(f"x6t must be [N, ny, nx, 2tr+2, 2tc+2, 128], got "
                         f"{tuple(x6t.shape)}")
    n, ny, nx, h6, w6, _ = x6t.shape
    tr, ttc = (h6 - 2) // 2, (w6 - 2) // 2
    if not ((ny - 1) * tr < hl <= ny * tr and (nx - 1) * ttc < wl <= nx * ttc):
        raise ValueError(f"{hl} x {wl} cells are not the image of a {ny} x "
                         f"{nx} grid of {tr} x {ttc} tiles")
    if x6t.dtype not in DTYPES or not x6t.is_contiguous():
        raise TypeError(f"x6t must be contiguous float32 or bfloat16, got "
                        f"{x6t.dtype}")
    w, b = sp[6]
    if w.dtype != x6t.dtype or w.device != x6t.device:
        raise TypeError(f"layer 7's weights are {w.dtype} on {w.device}")
    if out == "u8":
        if uvp is None:
            raise ValueError("out='u8' needs uvp [N, hl, wl, 8]")
        _check_uvp(uvp, x6t.new_empty(1).expand(n, hl, wl))
    if x6t.device.type == "cpu":
        y = l7_tiles_plain(x6t, _w7f(sp, x6t), b)
        return last_out(y[:, :hl, :wl], out, x6t.dtype, uvp, tc)
    dtc = _dense_tc(wl, tc) if out == "dense" else 0
    mode, tiling = _LAST_OUTS[out], (tr, ttc, ny, nx)
    with torch.cuda.device(x6t.device):
        y, cmap = _last_buffer(mode, x6t, n, hl, wl, dtc)
        _Launcher(None, x6t, None).l7_fold(x6t, sp, y, n, hl, wl, mode, uvp,
                                           cmap, dtc, tiling)
    return (y, dtc) if out == "dense" else y


CHAIN_ROWS = 256   # rows of x per block of the probe kernel


def pack_chain(w: torch.Tensor) -> torch.Tensor:
    """The probe's weights [P, 128, 128] (w_p[k, n]) -> [P, 16, 1, 128, 8]:
    pack_mma of each w_p as a 1 x 1 kernel."""
    return torch.stack([pack_mma(wk[None, None]) for wk in w])


def mma_chain_plain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of mma_chain: the P products as torch.matmul
    on f32 copies, summed in f32."""
    xf, acc = x.float(), None
    with no_tf32():
        for wk in wp:
            term = xf @ unpack_mma(wk)[0].float()
            acc = term if acc is None else acc.add_(term)
    return acc


def mma_chain(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The probe of the tensor-core kernel's inner loop: x [M, 128] bf16 and
    wp = pack_chain(w [P, 128, 128]) -> out [M, 128] f32 = the sum over p of
    x @ w_p, P back-to-back products through the layer kernel's device
    functions with the sums kept in registers. M must be a multiple of
    CHAIN_ROWS. CPU tensors take the plain version; CUDA tensors take the
    kernel, whose launch counts under MID_LAUNCHES["chain"] only."""
    if (x.dim() != 2 or x.shape[1] != 128 or x.shape[0] % CHAIN_ROWS
            or x.shape[0] < CHAIN_ROWS):
        raise ValueError(f"x must be [M, 128] with M a multiple of "
                         f"{CHAIN_ROWS}, got {tuple(x.shape)}")
    if wp.dim() != 5 or tuple(wp.shape[1:]) != (16, 1, 128, 8):
        raise ValueError(f"wp must be pack_chain's [P, 16, 1, 128, 8], got "
                         f"{tuple(wp.shape)}")
    for name, t in (("x", x), ("wp", wp)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous bfloat16")
    if wp.device != x.device:
        raise ValueError(f"wp on {wp.device}, x on {x.device}")
    if x.device.type == "cpu":
        return mma_chain_plain(x, wp)
    with torch.cuda.device(x.device):
        out = torch.empty((x.shape[0], 128), dtype=torch.float32,
                          device=x.device)
        libs = _libs()
        err = libs["mma"].w2x_mma_chain(
            1, x.data_ptr(), wp.data_ptr(), out.data_ptr(), x.shape[0],
            wp.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            msg = libs["mma"].w2x_error_string(err).decode()
            raise RuntimeError(f"mma_chain: {msg}")
        MID_LAUNCHES["chain"] += 1
    return out


def _spanned(kind: str):
    """Puts a stack entry inside a "w2x.stack" span (kernel and plain
    routes alike), with the wrapper's KERNEL_LAUNCHES kind, the input's
    dtype and shape, the launches the call made (the change in LAUNCHES)
    and, where it made any, the routes its bf16 layers 2-6 took
    (`mid_routes`, "route:count" for each MID_ROUTES count that changed,
    e.g. "mma_resident:4 mma_split:1")."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(x, *args, **kwargs):
            with trace.span("w2x.stack", on=x, kind=kind, dtype=x.dtype,
                            shape=x.shape) as s:
                before = LAUNCHES
                routes = [MID_LAUNCHES[r] for r in MID_ROUTES]
                out = fn(x, *args, **kwargs)
                s.set(launches=LAUNCHES - before)
                took = " ".join(f"{r}:{MID_LAUNCHES[r] - n}"
                                for r, n in zip(MID_ROUTES, routes)
                                if MID_LAUNCHES[r] != n)
                if took:
                    s.set(mid_routes=took)
            return out
        return entry
    return wrap


@_spanned("scale")
def stack_scale(ylow: torch.Tensor, sp, events=None, l6_i8=None,
                l6_wino=None, tile=None) -> torch.Tensor:
    """ylow [N, hl, wl] (f32 or bf16, contiguous) -> Y_s2d [N, hl, wl, 4].
    CPU tensors take the plain version; CUDA tensors take the kernel (see
    _launch for `events`, the module docstring for layer 6's forms)."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form)
    if ylow.device.type == "cpu":
        return stack_scale_plain(ylow, sp, l6_i8, l6_wino, tile)
    return _launch(ylow, sp, "scale", events, form=form, tile=tile)


def _check_upto(upto, out: str = "cell") -> None:
    if upto not in range(7):
        raise ValueError(f"upto must be 0..6, got {upto!r}")
    if out not in UPTO_OUTS or upto not in UPTO_OUTS[out]:
        raise ValueError(f"out={out!r} at upto {upto}: the forms are "
                         f"{ {k: list(v) for k, v in UPTO_OUTS.items()} }")


def stack_scale_upto(ylow: torch.Tensor, sp, upto: int, events=None,
                     l6_i8=None, l6_wino=None, tile=None,
                     out: str = "cell") -> torch.Tensor:
    """The scale stack stopped after layer `upto` (B7): ylow [N, hl, wl] ->
    [N, hl, wl, 4] in ylow's dtype, 4 values of that stage per s2d cell
    (i, j), with act_k the output of layer k, whose row r is image row
    r + k - 7:
      upto = 1..5  out[n, i, j, c] = act_k[n, 2i, 2j, c], c = 0..3; layers
                   k+1..7 are not launched.
      upto = 6     the same-cell tap partials of layer 7, no bias, no
                   LeakyReLU: out[n, i, j, A*2+B] = sum over dy < 2-A,
                   dx < 2-B and c of act_6[n, 2i+A+dy, 2j+B+dx, c] *
                   w7[dy, dx, c], after layer 6 in the form that l6_i8 /
                   l6_wino select.
      upto = 0     the low-res taps (0,0), (0,1), (0,2), (1,0) of the 3x3
                   window at cell (i, j) of ylow edge-padded by 4, no
                   convolution. The JAX kernel also adds to every value
                   of a tile one sum over its three neighbour blocks,
                   which it computes only to keep its compiler from
                   dropping their fetches and which depends on its tile
                   grid; the port leaves that constant out.
    upto + 1 launches (one more with l6_i8 at upto = 6). That is out="cell";
    the truncation probes' other forms (tools/fused_strip_probe.py:162,
    tools/k1_forensics.py:136) are:
      out="whole"       upto = 1..5: act_k itself, [N, 2hl+14-2k,
                        2wl+14-2k, C_k], halo and all: the buffer that
                        layer k's launch wrote, returned as it is (no
                        launch of its own, upto launches in all); upto = 0:
                        the low-res input window, ylow edge-padded by 4 on
                        every side, [N, hl+8, wl+8, 1] (one launch of the
                        gather).
      out="lane0"       upto = 0: the low-res tap (0,0) of the cell's
                        window, ylow[clamp(i-4), clamp(j-4)], in all 4
                        lanes, with no neighbour-sum constant (one launch).
      out="phase_taps"  upto = 6: the unfolded layer-7 partials of the
                        cell's pixel (0, 0): out[n, i, j, t] = sum over c of
                        act_6[n, 2i, 2j, c] * w7[dy_t, dx_t, c], (dy, dx) =
                        (0,0), (0,1), (0,2), (1,0), an f32 sum rounded once,
                        no bias and no LeakyReLU (7 launches, 8 with l6_i8).
    At upto 6 both tap forms are output forms of layer 7's fold (csrc/l7.cu:
    bf16 on the tensor cores, f32 with FFMA; on a plane or, under l6_i8, on
    the tile-major planes), Zt's lanes 0-3 of the cell, rounded once; the
    phase taps read pixel (0, 0) of each cell alone (StackParams.w7p).
    Their launches count under L7_LAUNCHES "fold" / "fold_f32" and
    TAP_LAUNCHES. At upto 0..5 the last launch is csrc/gather.cu's gather (a
    band of rows a block, 16-byte vectors, the low-res modes staged in
    shared memory), which only moves values (GATHER_LAUNCHES counts it). CPU
    tensors take the plain version; CUDA tensors take the kernels."""
    _check_upto(upto, out)
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form if upto == 6 else "direct")
    if ylow.device.type == "cpu":
        return stack_scale_upto_plain(ylow, sp, upto, l6_i8, l6_wino, tile,
                                      out)
    return _launch(ylow, sp, "scale", events, form=form, tile=tile,
                   upto=upto, out_form=out)


@_spanned("dense")
def stack_scale_dense(ylow: torch.Tensor, sp, tc=None, events=None,
                      l6_i8=None, l6_wino=None, tile=None):
    """ylow [N, hl, wl] -> (ydense [N, hl, nx*4*tc], tc): stack_scale's Y
    with the last layer storing it phase-chunked and dense (zeros past wl
    in the last chunk); dense_to_s2d(ydense, tc, hl, wl) gives stack_scale's
    output bit for bit. tc, a multiple of 32, defaults to the low-res
    width rounded up to 32, at most DENSE_TC. CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form)
    tc = _dense_tc(ylow.shape[2], tc)
    if ylow.device.type == "cpu":
        return stack_scale_dense_plain(ylow, sp, tc, l6_i8, l6_wino, tile)
    return _launch(ylow, sp, "dense", events, tc=tc, form=form,
                   tile=tile), tc


@_spanned("fused_u8")
def stack_scale_fused_u8(ylow: torch.Tensor, uvp: torch.Tensor, sp,
                         events=None, l6_i8=None, l6_wino=None,
                         tile=None) -> torch.Tensor:
    """ylow [N, hl, wl] + channel-major polyphase U/V uvp [N, hl, wl, 8]
    (f32, contiguous; u phases 0:4, v phases 4:8) -> u8 BGR
    [N, hl, wl, 16], lane c*4 + phase, lanes 12:16 zero: the whole 2x step's
    output, with the last layer's f32 Y going straight into the colour map.
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    form = l6_form(l6_i8, l6_wino)
    _check(ylow, sp, form)
    _check_uvp(uvp, ylow)
    if ylow.device.type == "cpu":
        return stack_scale_fused_u8_plain(ylow, uvp, sp, l6_i8, l6_wino,
                                          tile)
    return _launch(ylow, sp, "fused_u8", events, uvp=uvp, form=form,
                   tile=tile)


@_spanned("noise")
def stack_noise_s2d(y: torch.Tensor, sp, events=None, l6_i8=None,
                    l6_wino=None, tile=None) -> torch.Tensor:
    """y [N, h, w] (h, w even; f32 or bf16, contiguous) -> Y_s2d
    [N, h/2, w/2, 4]; raises on odd dims (stack_noise takes any size).
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    form = l6_form(l6_i8, l6_wino)
    _check(y, sp, form)
    _check_even(y, "stack_noise_s2d")
    if y.device.type == "cpu":
        return stack_noise_s2d_plain(y, sp, l6_i8, l6_wino, tile)
    return _launch(y, sp, "noise", events, form=form, tile=tile)


@_spanned("noise")
def stack_noise(y: torch.Tensor, sp, events=None, l6_i8=None, l6_wino=None,
                tile=None) -> torch.Tensor:
    """y [N, h, w] (any h, w) -> the denoised plane [N, h, w]: the kernel
    runs on the plane edge-padded to even (in its layer-1 index map) and
    the s2d result is interleaved (d2s) and cropped. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    form = l6_form(l6_i8, l6_wino)
    _check(y, sp, form)
    if y.device.type == "cpu":
        return stack_noise_plain(y, sp, l6_i8, l6_wino, tile)
    h, w = y.shape[1:]
    ys = _launch(y, sp, "noise", events, form=form, tile=tile)
    return d2s(ys)[:, :h, :w, 0]
