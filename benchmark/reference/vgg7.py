"""Plain PyTorch reference of a waifu2x conversion (the 7-layer VGG of
nagadomi/waifu2x `models/vgg_7`, as WL-Amigo/waifu2x-converter-cpp runs it).

Written from the model's published description and OpenCV's definitions,
independently of the program under test: it imports nothing of the port,
parses the model files itself and works out everything from the raw
weights. All arithmetic is float32 with TF32 off.

A conversion of u8 BGR frames [N, h, w, 3]:
  1. f32 = u8 / 255; the OpenCV RGB2YUV matrix applied to the BGR data as
     it lies (the converter's quirk: it feeds imread's BGR to RGB2YUV);
  2. optionally the noise model on the Y plane;
  3. the Y plane upscaled 2x by INTER_NEAREST and run through the scale
     model; U and V upscaled 2x by INTER_CUBIC (Keys, A = -0.75,
     replicated borders);
  4. YUV2RGB back, * 255, rounded half to even, clamped to u8.
Each model pads its input plane by 7 rows and columns (edge replicate) and
runs seven valid 3x3 correlations, each with its bias and LeakyReLU(0.1).

`precision` selects a lower-precision control for one stack: "fp8"
rounds each layer's input and weights to float8 e4m3 (per-tensor scale on
the activations, per-output-channel on the weights), "tf32" rounds them to
TF32's 10-bit mantissa; accumulation stays f32.

The harness reaches this module by a configuration's `reference` path and
calls its hooks: `weights` (a stack's layers), `convert_by_role` (the
conversion, models by role) and `LOWER` (the control's precisions).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.1
OFFSET = 7          # seven 3x3 layers: the receptive radius
BLOCK_PX = 4_000_000   # output pixels a block of rows holds at most
CUBIC_A = -0.75
# the control that sits one step below each stored precision
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def load_model(path: str) -> list:
    """A waifu2x model file (a JSON list of layers with nInputPlane,
    nOutputPlane, kW, kH, weight[out][in][kh][kw], bias[out]) ->
    [(w [out, in, kh, kw] f32, b [out] f32)] as CPU tensors."""
    with open(path, "rb") as f:
        doc = json.load(f)
    layers = []
    for i, layer in enumerate(doc):
        w = np.asarray(layer["weight"], dtype=np.float32)
        b = np.asarray(layer["bias"], dtype=np.float32)
        shape = (int(layer["nOutputPlane"]), int(layer["nInputPlane"]),
                 int(layer["kH"]), int(layer["kW"]))
        if w.shape != shape or b.shape != shape[:1]:
            raise ValueError(f"{path}: layer {i}: weight {w.shape}, bias "
                             f"{b.shape}, header {shape}")
        layers.append((torch.from_numpy(w), torch.from_numpy(b)))
    return layers


def weights(stack: dict, root, device=None) -> list:
    """A configuration's stack as `load_model`'s CPU layers: its model file
    (`model`, under `root`) held to the digest it states (`sha256`). vgg_7's
    configurations run the trained models, so it draws none from a seed,
    and `device` is not used."""
    path = Path(root) / stack["model"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != stack["sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration "
                           f"states {stack['sha256']}")
    return load_model(str(path))


@contextlib.contextmanager
def exact_f32():
    """Convolutions and matrix products in full f32 inside the block."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest value with a 10-bit mantissa (ties away from
    zero, as cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """f32 -> float8 e4m3 and back, scaled so that the largest |x| over
    `dims` maps to e4m3's largest finite value, 448."""
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _quantise(x, w, precision: str):
    if precision == "f32":
        return x, w
    if precision == "tf32":
        return round_tf32(x), round_tf32(w)
    if precision == "fp8":
        return round_fp8(x, None), round_fp8(w, (1, 2, 3))
    raise ValueError(f"unknown precision {precision!r}")


def _stack_block(x: torch.Tensor, layers, precision: str) -> torch.Tensor:
    """Seven valid 3x3 layers on x [N, 1, H, W] -> [N, 1, H - 14, W - 14]."""
    for w, b in layers:
        xq, wq = _quantise(x, w, precision)
        x = F.conv2d(xq, wq, b)
        x = torch.where(x < 0, x * LEAKY, x)
    return x


def run_stack(plane: torch.Tensor, layers, precision: str = "f32"
              ) -> torch.Tensor:
    """The model on planes [N, H, W] f32 -> [N, H, W]: the plane padded by
    OFFSET (edge replicate), then the layers, in blocks of output rows that
    each carry their OFFSET-row halo, so that the largest frames fit."""
    dev = plane.device
    layers = [(w.to(dev), b.to(dev)) for w, b in layers]
    n, h, w = plane.shape
    rows = max(16, BLOCK_PX // max(1, w))
    out = torch.empty_like(plane)
    with exact_f32():
        for i in range(n):
            padded = F.pad(plane[i][None, None], (OFFSET,) * 4,
                           mode="replicate")
            for r0 in range(0, h, rows):
                r1 = min(h, r0 + rows)
                block = padded[:, :, r0:r1 + 2 * OFFSET]
                out[i, r0:r1] = _stack_block(block, layers, precision)[0, 0]
    return out


# OpenCV's analog YUV constants (COLOR_RGB2YUV / COLOR_YUV2RGB, float path)
_KR, _KG, _KB = 0.299, 0.587, 0.114
_KU, _KV = 0.492, 0.877
_VR, _UG, _VG, _UB = 1.140, -0.395, -0.581, 2.032


def to_yuv(bgr_u8: torch.Tensor) -> torch.Tensor:
    """u8 [..., 3] -> f32 YUV [..., 3]. The channels are taken in the order
    they lie (B, G, R) as OpenCV's R, G, B: the converter's quirk."""
    x = bgr_u8.to(torch.float32) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _KR * r + _KG * g + _KB * b
    return torch.stack([y, _KU * (b - y) + 0.5, _KV * (r - y) + 0.5], -1)


def to_u8(yuv: torch.Tensor) -> torch.Tensor:
    """f32 YUV [..., 3] -> u8 [..., 3] in the order to_yuv took them."""
    y, u, v = yuv[..., 0], yuv[..., 1] - 0.5, yuv[..., 2] - 0.5
    rgb = torch.stack([y + _VR * v, y + _UG * u + _VG * v, y + _UB * u], -1)
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)


def nearest2x(plane: torch.Tensor) -> torch.Tensor:
    """INTER_NEAREST to twice the size: [N, H, W] -> [N, 2H, 2W]."""
    return plane.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _cubic_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """INTER_CUBIC to twice the length along `axis`: destination d samples
    the source at (d + 0.5) / 2 - 0.5 with Keys' kernel on the four
    neighbours of its floor, indices clamped to the edge."""
    n = x.shape[axis]
    d = torch.arange(2 * n, dtype=torch.float64)
    src = (d + 0.5) / 2 - 0.5
    base = torch.floor(src)
    t = (src - base).to(torch.float32)
    a = CUBIC_A
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1 - w0 - w1 - w2
    out = 0
    shape = [1] * x.dim()
    shape[axis] = 2 * n
    for k, wk in zip((-1, 0, 1, 2), (w0, w1, w2, w3)):
        idx = torch.clamp(base.long() + k, 0, n - 1).to(x.device)
        out = out + x.index_select(axis, idx) * wk.to(x.device).view(shape)
    return out


def cubic2x(plane: torch.Tensor) -> torch.Tensor:
    """INTER_CUBIC to twice the size of planes [N, H, W] (OpenCV resamples
    the rows first, then the columns)."""
    return _cubic_axis(_cubic_axis(plane, plane.dim() - 1), plane.dim() - 2)


def convert(bgr_u8: torch.Tensor, scale_layers=None, noise_layers=None,
            precisions=None):
    """u8 BGR [N, h, w, 3] -> (u8 BGR [N, 2h, 2w, 3], or [N, h, w, 3] with
    no scale model; the denoised Y plane [N, h, w] f32 or None): the noise
    model, the scale model, or the noise model then the scale model.
    precisions: role ("noise", "scale") -> precision, "f32" where absent."""
    if scale_layers is None and noise_layers is None:
        raise ValueError("a conversion needs a noise or a scale model")
    prec = {"noise": "f32", "scale": "f32", **(precisions or {})}
    yuv = to_yuv(bgr_u8)
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    y_noise = None
    if noise_layers is not None:
        y = y_noise = run_stack(y.contiguous(), noise_layers, prec["noise"])
    if scale_layers is not None:
        y = run_stack(nearest2x(y).contiguous(), scale_layers, prec["scale"])
        u, v = cubic2x(u.contiguous()), cubic2x(v.contiguous())
    return to_u8(torch.stack([y, u, v], -1)), y_noise


def convert_by_role(bgr_u8: torch.Tensor, layers: dict, precisions=None):
    """`convert` with the models by role ("scale", "noise": `weights`'
    layers) -> (u8 BGR frames, the denoised Y plane or None)."""
    return convert(bgr_u8, layers.get("scale"), layers.get("noise"),
                   precisions)
