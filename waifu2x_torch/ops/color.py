"""Colorspace transforms — bit-comparable to OpenCV's float cvtColor path.

The reference converts with cv::COLOR_RGB2YUV / COLOR_YUV2RGB on float32 data
(main.cpp:76, 171) and feeds cv::imread output, which is **BGR-ordered**, to
the RGB2YUV transform (the reference's faithful-output quirk): the matrix
rows meant for R are applied to B and vice versa. The round trip
YUV2RGB -> imwrite-as-BGR makes the final colors correct; only the
intermediate "Y" plane the CNN sees is computed from swapped R/B. The
pipeline feeds BGR-ordered tensors to `bgr_to_yuv`, which applies OpenCV's
*RGB2YUV* coefficients as-is.

Coefficients are OpenCV's analog-YUV constants:
    Y =  0.299 R + 0.587 G + 0.114 B
    U =  0.492 (B - Y) + 0.5
    V =  0.877 (R - Y) + 0.5
and the inverse
    R = Y + 1.140 (V - 0.5)
    G = Y - 0.395 (U - 0.5) - 0.581 (V - 0.5)
    B = Y + 2.032 (U - 0.5)
"""

from __future__ import annotations

import numpy as np
import torch

from waifu2x_torch.utils import trace

_R2Y, _G2Y, _B2Y = np.float32(0.299), np.float32(0.587), np.float32(0.114)
_B2U, _R2V = np.float32(0.492), np.float32(0.877)
_V2R, _U2G, _V2G, _U2B = (np.float32(1.140), np.float32(-0.395),
                          np.float32(-0.581), np.float32(2.032))
_DELTA = np.float32(0.5)

# forward matrix rows (computed in f32, matching OpenCV's stored tab):
#   U row = B2U * ([0,0,1] - Yrow);  V row = R2V * ([1,0,0] - Yrow)
_YROW = np.array([_R2Y, _G2Y, _B2Y], np.float32)
_FWD = np.stack([
    _YROW,
    (_B2U * (np.array([0, 0, 1], np.float32) - _YROW)).astype(np.float32),
    (_R2V * (np.array([1, 0, 0], np.float32) - _YROW)).astype(np.float32),
])  # [3 out, 3 in], input order (R, G, B) as OpenCV labels it
_FWD_OFF = np.array([0.0, _DELTA, _DELTA], np.float32)

_INV = np.array([
    [1.0, 0.0, _V2R],
    [1.0, _U2G, _V2G],
    [1.0, _U2B, 0.0],
], np.float32)
_INV_OFF = (-_INV @ np.array([0.0, _DELTA, _DELTA], np.float32)).astype(
    np.float32)


def _affine3(img: torch.Tensor, mat: np.ndarray,
             off: np.ndarray) -> torch.Tensor:
    """Per-pixel 3x3 affine transform as unrolled ELEMENTWISE ops.

    Deliberately not a matmul: a [..., 3] @ [3, 3] contraction may run at
    reduced precision (TF32 on the card); the elementwise form is exact
    f32, evaluated in the same order as the JAX package. The coefficients
    are f32 values passed as Python floats, which represent them exactly.
    """
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    outs = [c0 * float(mat[i, 0]) + c1 * float(mat[i, 1])
            + c2 * float(mat[i, 2]) + float(off[i]) for i in range(3)]
    return torch.stack(outs, dim=-1)


def bgr_to_yuv(img: torch.Tensor) -> torch.Tensor:
    """Apply OpenCV's RGB2YUV transform to a float [..., 3] image (BGR data
    on purpose, replicating main.cpp:74-76)."""
    with trace.span("w2x.colour", on=img):
        return _affine3(img, _FWD, _FWD_OFF)


def yuv_to_bgr(img: torch.Tensor) -> torch.Tensor:
    """Inverse transform (COLOR_YUV2RGB, main.cpp:171); emits the channel
    order that was fed to bgr_to_yuv (BGR in the pipeline)."""
    return _affine3(img, _INV, _INV_OFF)


def saturate_cast_u8(img: torch.Tensor) -> torch.Tensor:
    """float * 255 -> uint8 with OpenCV saturate-cast semantics
    (convertTo(CV_8U, 255.0), main.cpp:172): round-half-to-even, clamp."""
    scaled = img * 255.0
    return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)


def u8_to_unit_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255 (convertTo(CV_32F, 1/255), main.cpp:75)."""
    with trace.span("w2x.colour", on=img):
        return img.to(torch.float32) * float(np.float32(1.0 / 255.0))
