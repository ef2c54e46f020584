"""Space-to-depth (polyphase) layout helpers.

The scale path runs on the low-res grid and emits the converted luma in s2d
layout: channel (A*2 + B) of low-res cell (i, j) is full-res pixel
(2i + A, 2j + B). The final interleave to raster order happens on the host
as a zero-flop u8 reshape (`d2s_host_cmajor`).

Lane order convention everywhere: s2d channel index = (a*2 + b)*C + c,
a = row parity, b = column parity, c = original channel.
"""

from __future__ import annotations

import numpy as np
import torch


def s2d(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H/2, W/2, 4C] even space-to-depth."""
    *n, h, w, c = x.shape
    x = x.reshape(*n, h // 2, 2, w // 2, 2, c)
    x = torch.movedim(x, -4, -3)          # [..., h2, w2, 2, 2, c]
    return x.reshape(*n, h // 2, w // 2, 4 * c)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """[..., H2, W2, 4C] -> [..., 2*H2, 2*W2, C] inverse of s2d."""
    *n, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(*n, h2, w2, 2, 2, c)
    x = torch.movedim(x, -3, -4)          # [..., h2, 2, w2, 2, c]
    return x.reshape(*n, h2 * 2, w2 * 2, c)


def d2s_host(x: np.ndarray) -> np.ndarray:
    """Host-side d2s (numpy) for u8 output images."""
    *n, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(*n, h2, w2, 2, 2, c)
    x = np.moveaxis(x, -3, -4)
    return x.reshape(*n, h2 * 2, w2 * 2, c)


def d2s_host_cmajor(x: np.ndarray, channels: int = 3) -> np.ndarray:
    """Host d2s for CHANNEL-MAJOR polyphase layouts (lane = c*4 + (A*2+B)),
    the layout of the u8 tail: [..., h, w, 4c'] -> [..., 2h, 2w, channels]
    (trailing pad channels dropped)."""
    *n, h2, w2, c4 = x.shape
    c = c4 // 4
    v = x.reshape(*n, h2, w2, c, 2, 2)
    # [..., i, j, c, A, B] -> [..., i, A, j, B, c]
    v = np.moveaxis(np.moveaxis(v, -2, -4), -1, -2)
    return v.reshape(*n, h2 * 2, w2 * 2, c)[..., :channels]


_WINO_G = np.array([[1.0, 0.0, 0.0],
                    [0.5, 0.5, 0.5],
                    [0.5, -0.5, 0.5],
                    [0.0, 0.0, 1.0]], np.float32)
# F(2x2, 3x3) Winograd in correlation orientation (the stack's filter2D
# semantics): y[A] = sum_m d[A+m] g[m] with
#   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
#   A^T = [[1,1,1,0],[0,1,-1,-1]]
# The 4x4 input window of a 2x2 output block starts at the block's own
# top-left pixel. B^T and A^T hold only 0 and +-1, so the input and output
# transforms are adds; only G touches the weights. _WINO_BT_TAPS[p] lists
# the (window index, sign) terms of row p of B^T.
_WINO_BT_TAPS = (((0, 1.0), (2, -1.0)), ((1, 1.0), (2, 1.0)),
                 ((1, -1.0), (2, 1.0)), ((1, 1.0), (3, -1.0)))
_WINO_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


def pack_wino(w) -> np.ndarray:
    """One 3x3 layer's weights in the Winograd-transformed domain:
    [3, 3, ci, co] -> U [16, ci, co] with p = py*4 + px and
    U[p] = (G g G^T)[py, px] per (ci, co) pair. M[p] = V[p] @ U[p] then
    takes 16 multiply-adds per 2x2 output block, input and output channel
    where the direct form takes 36."""
    w = np.asarray(w, np.float32)
    if w.shape[:2] != (3, 3):
        raise ValueError(f"pack_wino takes 3x3 kernels, got {w.shape}")
    u = np.einsum("ak,bl,klio->abio", _WINO_G, _WINO_G, w)
    return np.ascontiguousarray(u.reshape(16, w.shape[2], w.shape[3]))


def pack_w2(w) -> np.ndarray:
    """[3,3,ci,co] -> [2,2,4ci,4co] weights of the s2d-space 2x2 conv:
    W2[Dy, Dx, (a, b, ci), (A, B, co)] = W[2Dy + a - A, 2Dx + b - B, ci, co],
    zero where the tap falls outside the 3 x 3 kernel."""
    w = np.asarray(w, np.float32)
    kh, kw, ci, co = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_w2 takes 3x3 kernels, got {w.shape}")
    # axes Dy Dx a b ci A B co
    out = np.zeros((2, 2, 2, 2, ci, 2, 2, co), np.float32)
    for Dy in range(2):
        for Dx in range(2):
            for a in range(2):
                for b in range(2):
                    for A in range(2):
                        for B in range(2):
                            dy = 2 * Dy + a - A
                            dx = 2 * Dx + b - B
                            if 0 <= dy < 3 and 0 <= dx < 3:
                                out[Dy, Dx, a, b, :, A, B, :] = w[dy, dx]
    return out.reshape(2, 2, 4 * ci, 4 * co)


def pack_l1_scale(w1) -> np.ndarray:
    """Layer 1 of the scale stack in the low-res plane's terms:
    [3,3,1,co] -> [9, 4co] f32, row t = dy'*3 + dx', lane (A*2 + B)*co + c.

    The stack's input is nearest-2x(ylow) edge-padded by 7, so s2d cell
    (K, J) of it holds pad4(ylow)[K + a, J + b] in phase (a, b), with
    pad4(ylow)[p, q] = ylow[clamp(p - 4), clamp(q - 4)]. Output phase
    (A, B) of layer 1's s2d cell (K, J), full-res pixel (2K + A, 2J + B),
    is then a 3 x 3 window of pad4(ylow) at (K, J) with the weights
        Weff[dy', dx'] = sum over Dy + a = dy', Dx + b = dx' of
                         W2[Dy, Dx, (a, b, 0), (A, B, c)]
    summed in f32 in this order; only the four rows dy' in {A, A+1},
    dx' in {B, B+1} are non-zero for phase (A, B). The storage dtype rounds
    each sum once (the JAX package's own packer and rounding point)."""
    w2 = pack_w2(np.asarray(w1, np.float32)).reshape(2, 2, 2, 2, -1)
    co4 = w2.shape[-1]
    eff = np.zeros((3, 3, co4), np.float32)
    for Dy in range(2):
        for Dx in range(2):
            for a in range(2):
                for b in range(2):
                    eff[Dy + a, Dx + b] += w2[Dy, Dx, a, b]
    return eff.reshape(9, co4)


def _k_major(w: torch.Tensor, k: int) -> torch.Tensor:
    """[kh, kw, ci, co] -> [ci/k, kh*kw, co, k]: out[c, t, o, j] =
    w[t // kw, t % kw, k*c + j, o]."""
    kh, kw, ci, co = w.shape
    return (w.reshape(kh * kw, ci // k, k, co).permute(1, 0, 3, 2)
            .contiguous())


def pack_mma(w) -> torch.Tensor:
    """One conv layer's weights in the order the tensor-core kernel reads
    them (csrc/mma.cu): [kh, kw, ci, co] -> [ci/8, kh*kw, co, 8] with
    out[c8, t, o, k] = w[t // kw, t % kw, 8*c8 + k, o]. Eight input
    channels of one output channel are 16 contiguous bytes in bf16, eight
    output channels of them one 128-byte core matrix of a K-major B
    operand, and a chunk of input channels is one contiguous run."""
    w = torch.as_tensor(w)
    if w.dim() != 4 or w.shape[2] % 8:
        raise ValueError(f"pack_mma takes [kh, kw, ci, co] with ci a "
                         f"multiple of 8, got {tuple(w.shape)}")
    return _k_major(w, 8)


def pack_mma_i8(q) -> torch.Tensor:
    """The int8 layer 6's weights as its tensor-core kernel reads them
    (csrc/i8.cu): int8 [ci, taps, co] (stack.unpack_w6q's layout) ->
    [ci/16, taps, co, 16] with out[c16, t, o, k] = q[16*c16 + k, t, o].
    Sixteen input channels of one output channel are 16 contiguous bytes,
    eight output channels of them one 128-byte core matrix of a K-major B
    operand: pack_mma's layout with a k32 step of int8 in place of a k16
    step of bf16. unpack_mma inverts it up to the order [taps, ci, co]."""
    q = torch.as_tensor(q)
    if q.dim() != 3 or q.shape[0] % 16 or q.dtype != torch.int8:
        raise ValueError(f"pack_mma_i8 takes int8 [ci, taps, co] with ci a "
                         f"multiple of 16, got {q.dtype} {tuple(q.shape)}")
    ci, taps, co = q.shape
    return q.reshape(ci // 16, 16, taps, co).permute(0, 2, 3, 1).contiguous()


def unpack_mma(wp: torch.Tensor) -> torch.Tensor:
    """pack_mma's (and pack_mma_tf32's) inverse up to the kernel's shape:
    [ci/k, taps, co, k] -> [taps, ci, co]."""
    ck, taps, co, k = wp.shape
    return wp.permute(1, 0, 3, 2).reshape(taps, ck * k, co)


_TF32_DROP = 0x1FFF   # the f32 mantissa bits a TF32 operand does not keep


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32. Finite inputs only."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (_TF32_DROP + 1) // 2) & ~_TF32_DROP).view(torch.float32)


def pack_mma_tf32(w) -> tuple:
    """One f32 conv layer's weights as the 3xTF32 kernel reads them
    (csrc/mma_tf32.cu): [kh, kw, ci, co] -> (hi, lo), each f32
    [ci/4, kh*kw, co, 4] laid out as pack_mma's with four input channels
    (16 bytes) to a core-matrix row. hi = tf32_round(w), lo =
    tf32_round(w - hi): both are TF32 values, which the tensor cores read
    whole, and hi + lo equals w to 2^-21 relative."""
    w = torch.as_tensor(w).float()
    if w.dim() != 4 or w.shape[2] % 4:
        raise ValueError(f"pack_mma_tf32 takes [kh, kw, ci, co] with ci a "
                         f"multiple of 4, got {tuple(w.shape)}")
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    return _k_major(hi, 4), _k_major(lo, 4)


def pack_l7_fold(w7) -> np.ndarray:
    """The last layer (3x3, ci -> 1) as one folded tap product (csrc/l7.cu):
    [3, 3, ci, 1] -> W [4*ci, 16].

    An input pixel of phase (a, b) (row and column parity) feeds, through
    tap (dy, dx), exactly one output phase (A, B) = ((a - dy) mod 2,
    (b - dx) mod 2) of the s2d cell (Dy, Dx) = ((A + dy) // 2, (B + dx) // 2)
    cells above and left of the input's own. So with the 4*ci values of
    s2d cell (I, J) of the layer-6 activation in lanes (a*2 + b)*ci + c:

        Zt[I, J, s*4 + q] = sum over k of X6_s2d[I, J, k] * W[k, s*4 + q]
        Y_s2d[i, j, q]    = sum over s = Dy*2 + Dx of Zt[i + Dy, j + Dx,
                                                         s*4 + q]

    with q = A*2 + B. Each entry of W is one weight or zero."""
    w7 = np.asarray(w7, np.float32)
    if w7.ndim != 4 or w7.shape[:2] != (3, 3) or w7.shape[3] != 1:
        raise ValueError(f"pack_l7_fold takes [3, 3, ci, 1], got "
                         f"{w7.shape}")
    ci = w7.shape[2]
    blk = np.zeros((4 * ci, 16), np.float32)
    for a in range(2):
        for b in range(2):
            for dy in range(3):
                for dx in range(3):
                    qa, qb = (a - dy) % 2, (b - dx) % 2
                    s = ((qa + dy) // 2) * 2 + (qb + dx) // 2
                    rows = slice((a * 2 + b) * ci, (a * 2 + b + 1) * ci)
                    blk[rows, s * 4 + qa * 2 + qb] += w7[dy, dx, :, 0]
    return blk


def pack_l7_ptaps(w7) -> np.ndarray:
    """Taps 0-3 of the last layer, unfolded, as the fold's weight
    (csrc/l7.cu's phase-taps form): [3, 3, ci, 1] -> W [4*ci, 16] with
    W[c, t] = w7[dy_t, dx_t, c, 0] for t = dy*3 + dx = 0..3, (dy, dx) =
    (0,0), (0,1), (0,2), (1,0), and every other entry zero. Rows 0..ci-1
    are the inputs of pixel (0, 0) of an s2d cell (pack_l7_fold's lane
    order), so Zt[I, J, t] = sum over c of X6[2I, 2J, c] * w7[dy_t, dx_t,
    c]: the unfolded partials of the cell's pixel (0, 0), read from that
    pixel alone."""
    w7 = np.asarray(w7, np.float32)
    if w7.ndim != 4 or w7.shape[:2] != (3, 3) or w7.shape[3] != 1:
        raise ValueError(f"pack_l7_ptaps takes [3, 3, ci, 1], got "
                         f"{w7.shape}")
    ci = w7.shape[2]
    blk = np.zeros((4 * ci, 16), np.float32)
    for t in range(4):
        blk[:ci, t] = w7[t // 3, t % 3, :, 0]
    return blk
