"""The int8 layer-6 path's fake-quantised twin of the f32 stack (the
forward half of the JAX package's train/qat.py).

The kernel's opt-in int8 mode (ops/stack.py, l6_i8) runs layer 6 as
int8 x int8 with a per-tile dynamic activation scale and per-output-channel
weight scales, exact sums. Its fidelity against the f32 stack is the
quantisation error of layer 6 on the given weights. `stack_valid_l6fq`
computes the stack with layer 6 under that contract in f32 arithmetic
(symmetric int8 values times their scales, a straight-through estimator
for gradients), with one activation scale per sample: a superset of the
kernel's per-tile maximum, the conservative case. `l6_quant_gap_db` is the
PSNR between the two stacks, the training-side proxy of the kernel's
measured int8 fidelity.

Not ported yet: make_qat_l6_loss and the training loop that uses it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_torch.ops.convstack import (
    conv_stack_valid,
    hwio_to_oihw,
    leaky_relu,
    no_tf32,
)

L6_INDEX = 5  # layer 6 of the flagship 7-layer stack (0-based)
_INV127 = float(np.float32(1 / 127.0))


def _fq(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 fake-quant with a straight-through estimator; the
    scale carries no gradient (constant per step, standard QAT)."""
    s = s.detach()
    q = torch.clamp(torch.round(v / s), -127, 127) * s
    return v + (q - v).detach()


def _conv(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 correlation, NHWC activations and HWIO weights."""
    return F.conv2d(x.permute(0, 3, 1, 2),
                    hwio_to_oihw(w_hwio.to(x.dtype))).permute(0, 2, 3, 1)


def _l6_fq_layer(x: torch.Tensor, p) -> torch.Tensor:
    """One layer under the kernel's int8 contract (fake-quantised, STE):
    dynamic per-sample activation scale, per-output-channel weight scales.
    x: [N, H, W, cin]."""
    w = p["w"]
    sx = torch.clamp(x.abs().amax(dim=(1, 2, 3), keepdim=True),
                     min=1e-8) * _INV127
    sw = torch.clamp(w.abs().amax(dim=(0, 1, 2), keepdim=True),
                     min=1e-12) * _INV127
    return leaky_relu(_conv(_fq(x, sx), _fq(w, sw)) + p["b"].to(x.dtype))


def stack_valid_l6fq(x: torch.Tensor, params) -> torch.Tensor:
    """conv_stack_valid's twin with layer 6 under the kernel's int8 contract.
    x: f32 [N, H, W, 1], already padded by the model offset; full f32 (TF32
    off)."""
    with no_tf32():
        for i, p in enumerate(params):
            if i == L6_INDEX:
                x = _l6_fq_layer(x, p)
            else:
                x = leaky_relu(_conv(x, p["w"]) + p["b"].to(x.dtype))
    return x


def l6_quant_gap_db(params, x: torch.Tensor) -> float:
    """PSNR (dB, unit peak) between the f32 stack and its layer-6
    fake-quantised twin on a batch x [N, H, W, 1]."""
    with torch.no_grad():
        a = conv_stack_valid(x, params).double()
        b = stack_valid_l6fq(x, params).double()
    mse = float(((a - b) ** 2).mean())
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))
