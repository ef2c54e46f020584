"""waifu2x UpCUNet: a cascade of two U-Nets that scales an RGB image 2x
(nagadomi/waifu2x's 2018 `cunet` models, `lib/srcnn.lua` `upcunet`;
nagadomi/nunif `waifu2x/models/cunet.py` `UpCUNet`; waifu2x-ncnn-vulkan's
default model).

Every convolution has a bias; leaky is LeakyReLU(0.1); cropN removes N
pixels from each side.

    UNetConv(i, m, o, se): conv3x3 i->m, leaky, conv3x3 m->o, leaky; with
        se, SE(o): z = mean of x over the tile's H and W, z = sigmoid(W2 .
        relu(W1 . z + b1) + b2) (W1 o -> o/8, W2 o/8 -> o, 1x1 convs),
        out = x * z by channel.
    UNet1(x): x1 = UNetConv(3, 32, 64)(x)
              x2 = UNetConv(64, 128, 64, se)(leaky(conv2x2/2 64->64 (x1)))
              x2 = leaky(convT2x2/2 64->64 (x2))
              x3 = leaky(conv3x3 64->64 (crop4(x1) + x2))
              z  = convT4x4/2 pad 3, 64->3 (x3)
    UNet2(x): x1 = UNetConv(3, 32, 64)(x)
              x2 = UNetConv(64, 64, 128, se)(leaky(conv2x2/2 64->64 (x1)))
              x3 = UNetConv(128, 256, 128, se)(leaky(conv2x2/2 128->128 (x2)))
              x3 = leaky(convT2x2/2 128->128 (x3))
              x4 = leaky(convT2x2/2 64->64 (UNetConv(128, 64, 64, se)(
                       crop4(x2) + x3)))
              x5 = leaky(conv3x3 64->64 (crop16(x1) + x4))
              z  = conv3x3 64->3 (x5)
    UpCUNet(x): a = UNet1(x); out = clamp(UNet2(a) + crop20(a), 0, 1)

A tile of S x S input pixels (S even) gives 2S - 72 output pixels a side:
the model's offset is 36 output (18 input) pixels. The SE means make the
tile size part of the function.

Parameters are a dict under the key names of nunif's
`UpCUNet.state_dict()` (`unet1.conv1.conv.0.weight`, ...,
`unet2.conv_bottom.bias`), f32 CPU tensors in PyTorch's layouts: a conv's
weight [out, in, kh, kw], a transposed conv's [in, out, kh, kw], so that
trained weights load without a rename. `save_params` / `load_params` keep
them in the port's own file format: that dict saved by `torch.save` (a
checkpoint that holds it under "state_dict" loads too).
"""

from __future__ import annotations

import dataclasses
import os

import torch

LEAKY = 0.1
SE_REDUCTION = 8
OFFSET = 36          # output pixels each side that a tile's edge leaves out
SCALE = 2


@dataclasses.dataclass(frozen=True)
class Layer:
    """One convolution of UpCUNet: its key prefix in nunif's state_dict,
    its kind ("conv3": 3x3 stride 1; "down": 2x2 stride 2; "up": transposed
    2x2 stride 2; "up4": transposed 4x4 stride 2 pad 3; "se1", "se2": an SE
    block's 1x1 convs), its widths and kernel size."""

    key: str
    kind: str
    cin: int
    cout: int

    @property
    def ksize(self) -> int:
        return {"conv3": 3, "down": 2, "up": 2, "up4": 4}.get(self.kind, 1)

    @property
    def transposed(self) -> bool:
        return self.kind in ("up", "up4")

    def weight_shape(self) -> tuple:
        k = self.ksize
        if self.transposed:
            return self.cin, self.cout, k, k
        return self.cout, self.cin, k, k


def _unetconv(key: str, i: int, m: int, o: int, se: bool) -> list:
    layers = [Layer(f"{key}.conv.0", "conv3", i, m),
              Layer(f"{key}.conv.2", "conv3", m, o)]
    if se:
        r = o // SE_REDUCTION
        layers += [Layer(f"{key}.seblock.conv1", "se1", o, r),
                   Layer(f"{key}.seblock.conv2", "se2", r, o)]
    return layers


# every convolution in the order the forward pass runs it
LAYERS = (
    *_unetconv("unet1.conv1", 3, 32, 64, False),
    Layer("unet1.conv1_down", "down", 64, 64),
    *_unetconv("unet1.conv2", 64, 128, 64, True),
    Layer("unet1.conv2_up", "up", 64, 64),
    Layer("unet1.conv3", "conv3", 64, 64),
    Layer("unet1.conv_bottom", "up4", 64, 3),
    *_unetconv("unet2.conv1", 3, 32, 64, False),
    Layer("unet2.conv1_down", "down", 64, 64),
    *_unetconv("unet2.conv2", 64, 64, 128, True),
    Layer("unet2.conv2_down", "down", 128, 128),
    *_unetconv("unet2.conv3", 128, 256, 128, True),
    Layer("unet2.conv3_up", "up", 128, 128),
    *_unetconv("unet2.conv4", 128, 64, 64, True),
    Layer("unet2.conv4_up", "up", 64, 64),
    Layer("unet2.conv5", "conv3", 64, 64),
    Layer("unet2.conv_bottom", "conv3", 64, 3),
)
BY_KEY = {layer.key: layer for layer in LAYERS}
SE_BLOCKS = ("unet1.conv2", "unet2.conv2", "unet2.conv3", "unet2.conv4")


def param_shapes() -> dict:
    """state_dict key -> shape, in LAYERS' order."""
    out = {}
    for layer in LAYERS:
        out[f"{layer.key}.weight"] = layer.weight_shape()
        out[f"{layer.key}.bias"] = (layer.cout,)
    return out


def check_tile(size: int) -> None:
    """A tile side the model takes: even, and large enough that every layer
    has an output (the smallest is 74: 2 output pixels a side)."""
    if size % 2 or size < 74:
        raise ValueError(f"an UpCUNet tile is an even side of at least 74 "
                         f"pixels, got {size}")


def layer_sides(size: int) -> dict:
    """Layer key -> (input side, output side) in a tile of `size` input
    pixels a side."""
    check_tile(size)
    sides = {}

    def conv(key, side):
        k = BY_KEY[key]
        if k.kind == "conv3":
            out = side - 2
        elif k.kind == "down":
            out = side // 2
        elif k.kind == "up":
            out = 2 * side
        elif k.kind == "up4":
            out = 2 * side - 4
        else:
            out = 1
        sides[key] = (side, out)
        return out

    def unetconv(key, side, se):
        side = conv(f"{key}.conv.2", conv(f"{key}.conv.0", side))
        if se:
            conv(f"{key}.seblock.conv2", conv(f"{key}.seblock.conv1", 1))
        return side

    s1 = unetconv("unet1.conv1", size, False)
    s2 = unetconv("unet1.conv2", conv("unet1.conv1_down", s1), True)
    s2 = conv("unet1.conv2_up", s2)
    assert s1 - 8 == s2
    a = conv("unet1.conv_bottom", conv("unet1.conv3", s2))
    s1 = unetconv("unet2.conv1", a, False)
    s2 = unetconv("unet2.conv2", conv("unet2.conv1_down", s1), True)
    s3 = unetconv("unet2.conv3", conv("unet2.conv2_down", s2), True)
    s3 = conv("unet2.conv3_up", s3)
    assert s2 - 8 == s3
    s4 = conv("unet2.conv4_up", unetconv("unet2.conv4", s3, True))
    assert s1 - 32 == s4
    z = conv("unet2.conv_bottom", conv("unet2.conv5", s4))
    assert z == a - 40 == out_side(size)
    return sides


def out_side(size: int) -> int:
    """Output pixels a side of a tile of `size` input pixels."""
    return SCALE * size - 2 * OFFSET


def layer_macs(size: int) -> dict:
    """Layer key -> multiply-adds over one tile of `size` pixels a side
    (a transposed conv counts each input pixel times its kernel)."""
    out = {}
    for key, (side_in, side_out) in layer_sides(size).items():
        k = BY_KEY[key]
        taps = k.ksize * k.ksize
        px = side_in * side_in if k.transposed else side_out * side_out
        out[key] = px * taps * k.cin * k.cout
    return out


def tile_macs(size: int) -> int:
    """Multiply-adds of the whole model over one tile."""
    return sum(layer_macs(size).values())


def init_params(seed: int) -> dict:
    """Seeded weights for a model with no trained file (benchmark/reference/
    upcunet.py draws the same): each convolution N(0, 2 / (fan_in (1 +
    0.1^2))) (He's for LeakyReLU 0.1; a transposed one's fan-in cin (k /
    2)^2), biases 0.01 N(0, 1), drawn in LAYERS' order, weight then bias,
    from one CPU generator; then changes that keep the output image-like
    rather than saturated, and make each SE block's gate follow its tile's
    means: an identity path that carries the input's three channels
    through UNet1 (in the first two convs and conv3 output c takes input
    c's centre tap 1 and its other weights x 0.02, bias 0; conv2_up's
    outputs 0-2 x 0.1, bias 0), a bilinear 2x kernel on UNet1's last layer
    from channel c to c (its other weights x 0.02, bias 0), UNet2's last
    layer x 0.15, bias 0, so that its residual adds texture of some 25
    levels to the upscaled input, and each SE block's first 1x1 conv x 10,
    so that a gate follows its own tile's means (on the benchmark's frames
    it moves by some 10-20% between them and the whole frame's)."""
    g = torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))
    params = {}
    for layer in LAYERS:
        shape = layer.weight_shape()
        fan_in = layer.cin * layer.ksize * layer.ksize
        if layer.transposed:   # each output sums cin x (k / 2)^2 taps
            fan_in = layer.cin * (layer.ksize // 2) ** 2
        std = (2.0 / (fan_in * (1 + LEAKY ** 2))) ** 0.5
        w = torch.randn(shape, generator=g) * std
        b = torch.randn((layer.cout,), generator=g) * 0.01
        params[f"{layer.key}.weight"] = w
        params[f"{layer.key}.bias"] = b
    for key in ("unet1.conv1.conv.0", "unet1.conv1.conv.2", "unet1.conv3"):
        w = params[f"{key}.weight"]
        for c in range(3):
            w[c] *= 0.02
            w[c, c, 1, 1] = 1.0
        params[f"{key}.bias"][:3] = 0.0
    params["unet1.conv2_up.weight"][:, :3] *= 0.1   # [in, out, 2, 2]
    params["unet1.conv2_up.bias"][:3] = 0.0
    w = params["unet1.conv_bottom.weight"]          # [64, 3, 4, 4]
    w *= 0.02
    tent = torch.tensor([0.25, 0.75, 0.75, 0.25])
    for c in range(3):
        w[c, c] = tent[:, None] * tent[None, :]
    params["unet1.conv_bottom.bias"].zero_()
    params["unet2.conv_bottom.weight"] *= 0.15
    params["unet2.conv_bottom.bias"].zero_()
    for key in SE_BLOCKS:
        params[f"{key}.seblock.conv1.weight"] *= 10.0
    return params


def validate_params(params) -> None:
    """Raises ValueError unless `params` holds exactly UpCUNet's keys with
    their shapes, as floating-point tensors with finite values."""
    want = param_shapes()
    have = set(params)
    if have != set(want):
        missing = sorted(set(want) - have)[:4]
        extra = sorted(have - set(want))[:4]
        raise ValueError(f"not UpCUNet's parameters: missing {missing}, "
                         f"unexpected {extra}")
    for key, shape in want.items():
        t = params[key]
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise ValueError(f"{key}: not a floating-point tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want {shape}")
        if not torch.isfinite(t).all():
            raise ValueError(f"{key}: values that are not finite")


def save_params(path: "str | os.PathLike", params) -> None:
    """The port's file format: the state_dict, f32 on the CPU, by
    torch.save."""
    validate_params(params)
    torch.save({k: params[k].detach().to("cpu", torch.float32).contiguous()
                for k in param_shapes()}, path)


def load_params(path: "str | os.PathLike") -> dict:
    """Parameters from `save_params`' file, or from a checkpoint that holds
    that dict under "state_dict" (tensors only; nothing is executed)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(
            obj["state_dict"], dict):
        obj = obj["state_dict"]
    params = {k: v.to(torch.float32) for k, v in obj.items()}
    validate_params(params)
    return params
