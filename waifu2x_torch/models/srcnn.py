"""Model architecture spec for the waifu2x 7-layer SRCNN conv stack.

The architecture is fixed by the reference model files
(appendix/waifu2x-nocuda/lib/srcnn.lua:10-32):

    Conv 1->32 (3x3) -> LeakyReLU(0.1)
    Conv 32->32      -> LeakyReLU(0.1)
    Conv 32->64      -> LeakyReLU(0.1)
    Conv 64->64      -> LeakyReLU(0.1)
    Conv 64->128     -> LeakyReLU(0.1)
    Conv 128->128    -> LeakyReLU(0.1)
    Conv 128->1      -> LeakyReLU(0.1)   # applied after the LAST layer too
                                         # (reference: modelHandler.cpp:148-152)

Every conv is stride-1 correlation (cv::filter2D semantics); the stack's
total receptive radius ("offset") is the number of layers: 7.

Parameters at the port's public functions are the JAX package's format: a
tuple of per-layer dicts {"w": f32[kh, kw, cin, cout] (HWIO), "b": f32[cout]},
as torch tensors. `SRCNN` holds one model's layers as an nn.Module (OIHW
`nn.Conv2d` weights) for the non-kernel path.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from waifu2x_torch.ops.convstack import (
    LEAKY_SLOPE,  # noqa: F401  (re-exported, as the JAX package has it)
    conv_stack_nchw,
    hwio_to_oihw,
    pad_replicate,
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    cin: int
    cout: int
    ksize: int = 3


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A conv-stack architecture: plane widths and kernel size per layer."""

    layers: tuple[LayerSpec, ...]

    @property
    def offset(self) -> int:
        """Total receptive radius = rows of context each output pixel needs
        (srcnn.lua:31; the halo/pad width of convertRoutine.cpp:35)."""
        return sum(l.ksize // 2 for l in self.layers)

    @classmethod
    def from_widths(cls, widths: Sequence[int], ksize: int = 3) -> "ModelSpec":
        return cls(tuple(LayerSpec(cin, cout, ksize)
                         for cin, cout in zip(widths[:-1], widths[1:])))

    @classmethod
    def from_params(cls, params) -> "ModelSpec":
        return cls(tuple(LayerSpec(int(p["w"].shape[2]), int(p["w"].shape[3]),
                                   int(p["w"].shape[0]))
                         for p in params))


# The one architecture the reference ships (noise1/noise2/scale2.0x all share
# it): plane widths 1->32->32->64->64->128->128->1 (srcnn.lua:13-25).
WAIFU2X_7LAYER = ModelSpec.from_widths([1, 32, 32, 64, 64, 128, 128, 1])


def init_params(seed: int, spec: ModelSpec = WAIFU2X_7LAYER,
                dtype=torch.float32):
    """He-normal initialised parameters from a seed (torch.Generator), for
    tests and synthetic runs. The reference is inference-only and always
    loads trained JSON weights."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for layer in spec.layers:
        fan_in = layer.ksize * layer.ksize * layer.cin
        w = torch.randn((layer.ksize, layer.ksize, layer.cin, layer.cout),
                        generator=gen, dtype=dtype) * (2.0 / fan_in) ** 0.5
        params.append({"w": w, "b": torch.zeros((layer.cout,), dtype=dtype)})
    return tuple(params)


def validate_params(params, spec: ModelSpec | None = None) -> ModelSpec:
    """Shape-check a parameter tuple; mirrors the reference loader's
    validation (modelHandler.hpp:48-71 requires kW == kH; filter() checks the
    plane chain at modelHandler.cpp:29-35). Returns the inferred ModelSpec."""
    if len(params) == 0:
        raise ValueError("empty model: no conv layers")
    prev_cout = None
    for i, p in enumerate(params):
        w, b = p["w"], p["b"]
        if w.ndim != 4:
            raise ValueError(f"layer {i}: weight must be [kh,kw,cin,cout], "
                             f"got shape {tuple(w.shape)}")
        kh, kw, cin, cout = w.shape
        if kh != kw:
            raise ValueError(f"layer {i}: kernel must be square (kW==kH), "
                             f"got {kh}x{kw}")
        if kh % 2 != 1:
            raise ValueError(f"layer {i}: kernel size must be odd, got {kh}")
        if tuple(b.shape) != (cout,):
            raise ValueError(f"layer {i}: bias shape {tuple(b.shape)} != "
                             f"({cout},)")
        if prev_cout is not None and cin != prev_cout:
            raise ValueError(f"layer {i}: cin={cin} does not chain from "
                             f"previous layer's cout={prev_cout}")
        prev_cout = cout
    if int(params[0]["w"].shape[2]) != 1:
        raise ValueError("first layer must take 1 input plane (luma)")
    if prev_cout != 1:
        raise ValueError("last layer must emit 1 output plane (luma)")
    inferred = ModelSpec.from_params(params)
    if spec is not None and inferred != spec:
        raise ValueError(f"params do not match spec: {inferred} != {spec}")
    return inferred


def count_maccs_per_pixel(spec: ModelSpec = WAIFU2X_7LAYER) -> int:
    """Multiply-accumulates per output pixel of the stack."""
    return sum(l.cin * l.cout * l.ksize * l.ksize for l in spec.layers)


class SRCNN(nn.Module):
    """One model's layers: VALID 3x3 convs, each followed by LeakyReLU."""

    def __init__(self, spec: ModelSpec = WAIFU2X_7LAYER):
        super().__init__()
        self.spec = spec
        self.convs = nn.ModuleList(
            nn.Conv2d(l.cin, l.cout, l.ksize) for l in spec.layers)

    @classmethod
    def from_params(cls, params) -> "SRCNN":
        model = cls(validate_params(params))
        with torch.no_grad():
            for conv, p in zip(model.convs, params):
                conv.weight.copy_(hwio_to_oihw(torch.as_tensor(p["w"])))
                conv.bias.copy_(torch.as_tensor(p["b"]))
        return model.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, C, H, W] padded input -> [N, 1, H - 2*offset,
        W - 2*offset]."""
        return conv_stack_nchw(x, [(c.weight, c.bias) for c in self.convs])

    def convert_plane(self, y: torch.Tensor) -> torch.Tensor:
        """Same-size plane conversion of y [N, H, W] (ops.convstack's
        convert_plane with this module's weights)."""
        return self(pad_replicate(y, self.spec.offset))[:, 0]
