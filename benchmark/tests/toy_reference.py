"""The plain reference of a toy architecture that the harness's tests run
beside vgg_7, to show that a configuration brings its architecture in files
of its own: two 3x3 layers on the frame's three channels as they lie, in
[0, 1] and edge-replicated by 2 (3 -> 8, bias, LeakyReLU 0.1; 8 -> 12,
bias), a pixel shuffle of the 12 channels to 2x the size in 3, clamped to
[0, 1], * 255, rounded half to even, u8. Weights from the stack's seed.
All arithmetic f32 with TF32 off; `precisions` rounds each layer's input
and weights one step lower ("tf32", or "fp8" e4m3 per tensor)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOWER = {"float32": "tf32", "bfloat16": "fp8"}
WIDTHS = (3, 8, 12)


def weights(stack: dict, root, device=None) -> list:
    """[(w [out, in, 3, 3], b [out]) f32] drawn from `stack["seed"]` in one
    call: weights normal * sqrt(2 / fan-in), biases normal * 0.05."""
    device = device or "cpu"
    g = torch.Generator(device=device)
    g.manual_seed(int(stack["seed"]))
    pairs = list(zip(WIDTHS, WIDTHS[1:]))
    sizes = [n for ci, co in pairs for n in (co * ci * 9, co)]
    parts = iter(torch.split(torch.randn(sum(sizes), generator=g,
                                         device=device), sizes))
    return [(next(parts).view(co, ci, 3, 3) * (2.0 / (9 * ci)) ** 0.5,
             next(parts) * 0.05) for ci, co in pairs]


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = x.abs().max().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown precision {precision!r}")


def convert_by_role(bgr_u8: torch.Tensor, layers: dict, precisions=None):
    """u8 [N, h, w, 3] -> (u8 [N, 2h, 2w, 3], None), the one stack's role
    being "sr"."""
    prec = (precisions or {}).get("sr", "f32")
    (w1, b1), (w2, b2) = [(w.to(bgr_u8.device), b.to(bgr_u8.device))
                          for w, b in layers["sr"]]
    x = bgr_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    x = F.pad(x, (2, 2, 2, 2), mode="replicate")
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        x = F.conv2d(_round(x, prec), _round(w1, prec), b1)
        x = torch.where(x < 0, 0.1 * x, x)
        x = F.conv2d(_round(x, prec), _round(w2, prec), b2)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved
    x = torch.clamp(F.pixel_shuffle(x, 2), 0.0, 1.0)
    out = torch.round(x * 255.0).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous(), None
