"""Quantisation-aware finetuning for the int8 layer-6 path (the counterpart
of the JAX package's train/qat.py).

The kernel's opt-in int8 mode (ops/stack.py, l6_i8) runs layer 6 as
int8 x int8 with a per-tile dynamic activation scale and per-output-channel
weight scales, exact sums. Its fidelity against the f32 stack is the
quantisation error of layer 6 on the given weights, which rescaling layers
5 and 6 cannot move; training the weights so that the f32 stack and its
fake-quantised twin agree can. `stack_valid_l6fq` computes the stack with
layer 6 under that contract in f32 arithmetic (symmetric int8 values times
their scales, a straight-through estimator for gradients), with one
activation scale per sample: a superset of the kernel's per-tile maximum,
the conservative case. `l6_quant_gap_db` is the PSNR between the two
stacks, the training-side proxy of the kernel's measured int8 fidelity.
`make_qat_l6_loss(mu)` is the coupled loss

    MSE(f32_stack(x), y) + mu * MSE(fq_stack(x), f32_stack(x))

for train/train.py's steps, with layers 1-5 computed once and only the
layer-6/7 tails branched.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_torch.ops.convstack import hwio_to_oihw, leaky_relu
from waifu2x_torch.train.train import layer, precision_flags, stack_valid

L6_INDEX = 5  # layer 6 of the flagship 7-layer stack (0-based)
_INV127 = float(np.float32(1 / 127.0))


def _fq(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 fake-quant with a straight-through estimator; the
    scale carries no gradient (constant per step, standard QAT)."""
    s = s.detach()
    q = torch.clamp(torch.round(v / s), -127, 127) * s
    return v + (q - v).detach()


def sample_absmax(h: torch.Tensor) -> torch.Tensor:
    """max |h| of each sample of an NCHW batch: [N]."""
    return h.detach().abs().amax(dim=(1, 2, 3))


def _l6_fq_layer(h: torch.Tensor, p, absmax=None) -> torch.Tensor:
    """One layer under the kernel's int8 contract (fake-quantised, STE) on
    NCHW h: dynamic per-sample activation scale (from `absmax` [N] where
    given, else h's own per-sample maximum), per-output-channel weight
    scales."""
    w = p["w"]
    m = sample_absmax(h) if absmax is None else absmax
    sx = torch.clamp(m.to(h.dtype), min=1e-8).view(-1, 1, 1, 1) * _INV127
    sw = torch.clamp(w.abs().amax(dim=(0, 1, 2), keepdim=True),
                     min=1e-12) * _INV127
    return leaky_relu(F.conv2d(_fq(h, sx), hwio_to_oihw(_fq(w, sw)).to(
        h.dtype)) + p["b"].to(h.dtype).view(1, -1, 1, 1))


def stack_valid_l6fq(x: torch.Tensor, params,
                     precision: "str | None" = "highest") -> torch.Tensor:
    """conv_stack_valid's twin with layer 6 under the kernel's int8 contract.
    x: f32 [N, H, W, 1], already padded by the model offset."""
    with precision_flags(precision):
        h = x.permute(0, 3, 1, 2)
        for i, p in enumerate(params):
            h = _l6_fq_layer(h, p) if i == L6_INDEX else layer(h, p)
    return h.permute(0, 2, 3, 1)


class QatL6Loss:
    """loss(params, x, y, precision="highest", absmax=None): task MSE on the
    f32 stack plus mu x the f32-vs-fake-quant output gap (the int8 fidelity
    term). `absmax` [N] replaces the per-sample maximum of layer 6's input
    that the activation scale is taken from: a step that splits a sample's
    columns over positions (train.make_sharded_train_step) gets every
    position's maxima from `l6_absmax` first and passes their maximum, the
    whole sample's, as the unsplit loss has it."""

    def __init__(self, mu: float = 4.0):
        self.mu = float(mu)

    @staticmethod
    def _prefix(params, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for p in params[:L6_INDEX]:
            h = layer(h, p)
        return h

    def l6_absmax(self, params, x: torch.Tensor,
                  precision: "str | None" = "highest") -> torch.Tensor:
        """Per-sample max |layer 6's input| over x [N, H, W, 1]: [N], no
        gradient."""
        with torch.no_grad(), precision_flags(precision):
            return sample_absmax(self._prefix(params, x))

    def __call__(self, params, x: torch.Tensor, y: torch.Tensor,
                 precision: "str | None" = "highest",
                 absmax: "torch.Tensor | None" = None) -> torch.Tensor:
        with precision_flags(precision):
            h = self._prefix(params, x)
            pred = h
            for p in params[L6_INDEX:]:
                pred = layer(pred, p)
            predq = _l6_fq_layer(h, params[L6_INDEX], absmax)
            for p in params[L6_INDEX + 1:]:
                predq = layer(predq, p)
        task = torch.mean((pred - y.permute(0, 3, 1, 2)) ** 2)
        fid = torch.mean((predq - pred) ** 2)
        return task + self.mu * fid


def make_qat_l6_loss(mu: float = 4.0) -> QatL6Loss:
    """The loss for train_loop(loss=...) and the train steps (QatL6Loss)."""
    return QatL6Loss(mu)


def l6_quant_gap_db(params, x: torch.Tensor,
                    precision: "str | None" = "highest") -> float:
    """PSNR (dB, unit peak) between the f32 stack and its layer-6
    fake-quantised twin on a batch x [N, H, W, 1]."""
    with torch.no_grad():
        a = stack_valid(x, params, precision).double()
        b = stack_valid_l6fq(x, params, precision).double()
    mse = float(((a - b) ** 2).mean())
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))
