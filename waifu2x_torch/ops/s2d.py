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
