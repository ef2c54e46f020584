"""Plain PyTorch reference of a waifu2x UpCUNet 2x conversion (nagadomi/
waifu2x's 2018 `cunet`, `lib/srcnn.lua` `upcunet`; nagadomi/nunif
`waifu2x/models/cunet.py` `UpCUNet`), written from the model's equations
(configs/upcunet2x.json states them) and independent of the program under
test: it imports nothing of the port. All arithmetic is float32 in NCHW
with TF32 off.

A conversion of u8 BGR frames [N, h, w, 3]:
  1. x = the frame / 255, its channels reversed to RGB;
  2. the frame padded by 18 pixels of edge replicate on every side, its
     far sides further (replicate) to a multiple of the step S - 36;
     tiles of S x S cut at that step, each computed alone (its SE means
     over itself; a row of tiles in one batched call), each giving
     (2S - 72)^2 output pixels, which tile the output with no overlap;
  3. UpCUNet on each tile: a = UNet1(x); clamp(UNet2(a) + crop20(a), 0, 1);
  4. the tiles stitched, cropped to 2h x 2w, * 255, rounded half to even,
     u8, back to BGR.

`precision` selects a lower-precision control: "fp8" rounds each
convolution's input and weights to float8 e4m3 (per-tensor scale on the
input, per-output-channel on the weights), "tf32" rounds them to TF32's
10-bit mantissa; sums, the SE vector and the residual stay f32.

Hooks the harness calls: `weights` (the stack's seeded parameters and its
tile), `convert_by_role` and `LOWER`.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LEAKY = 0.1
HALO = 18           # input pixels of context each side of a tile's output
LOWER = {"float32": "tf32", "bfloat16": "fp8"}

# (key, kind, cin, cout), kind: c3 conv 3x3, dn conv 2x2 stride 2, up
# transposed 2x2 stride 2, up4 transposed 4x4 stride 2 pad 3, s1 / s2 an
# SE block's 1x1 convs; nunif's state_dict names
_UC = {"unet1.conv1": (3, 32, 64, False), "unet1.conv2": (64, 128, 64, True),
       "unet2.conv1": (3, 32, 64, False), "unet2.conv2": (64, 64, 128, True),
       "unet2.conv3": (128, 256, 128, True),
       "unet2.conv4": (128, 64, 64, True)}


def _layers() -> list:
    out = []

    def uc(key):
        i, m, o, se = _UC[key]
        out.extend([(f"{key}.conv.0", "c3", i, m), (f"{key}.conv.2", "c3", m, o)])
        if se:
            out.extend([(f"{key}.seblock.conv1", "s1", o, o // 8),
                        (f"{key}.seblock.conv2", "s2", o // 8, o)])

    uc("unet1.conv1")
    out.append(("unet1.conv1_down", "dn", 64, 64))
    uc("unet1.conv2")
    out += [("unet1.conv2_up", "up", 64, 64), ("unet1.conv3", "c3", 64, 64),
            ("unet1.conv_bottom", "up4", 64, 3)]
    uc("unet2.conv1")
    out.append(("unet2.conv1_down", "dn", 64, 64))
    uc("unet2.conv2")
    out.append(("unet2.conv2_down", "dn", 128, 128))
    uc("unet2.conv3")
    out.append(("unet2.conv3_up", "up", 128, 128))
    uc("unet2.conv4")
    out += [("unet2.conv4_up", "up", 64, 64), ("unet2.conv5", "c3", 64, 64),
            ("unet2.conv_bottom", "c3", 64, 3)]
    return out


LAYERS = _layers()
SE_GAINED = [k for k, (_, _, _, se) in _UC.items() if se]
_K = {"c3": 3, "dn": 2, "up": 2, "up4": 4, "s1": 1, "s2": 1}


def shapes(tile: int) -> list:
    """Every convolution of one tile of `tile` pixels a side, in the order
    the forward pass runs them: (key, kind, cin, cout, input side, output
    side), read off the forward pass itself on meta tensors (no arithmetic);
    an SE block's 1x1 convs take a side of 1."""
    seen = []

    class Shapes(_Net):
        def conv(self, x, key, kind):
            y = super().conv(x, key, kind)
            seen.append((key, kind, x.shape[1], y.shape[1], x.shape[2],
                         y.shape[2]))
            return y

    params = {}
    for key, kind, ci, co in LAYERS:
        k = _K[kind]
        shape = (ci, co, k, k) if kind in ("up", "up4") else (co, ci, k, k)
        params[f"{key}.weight"] = torch.empty(shape, device="meta")
        params[f"{key}.bias"] = torch.empty((co,), device="meta")
    Shapes(params, "meta", "f32")(torch.empty((1, 3, tile, tile),
                                              device="meta"))
    return seen


def init_params(seed: int) -> dict:
    """The seeded initialiser the configuration states: each convolution
    N(0, 2 / (fan_in (1 + 0.1^2))) (a transposed one's fan-in: cin x
    (k / 2)^2), biases 0.01 N(0, 1), drawn in LAYERS' order (weight, then
    bias) from one CPU generator; then an identity path for the input's
    three channels through UNet1 (output c of the first two convs and of
    conv3: input c's centre tap 1, its other weights x 0.02, bias 0;
    conv2_up's outputs 0-2 x 0.1, bias 0), UNet1's last layer x 0.02 with a
    bilinear kernel from channel c to c and bias 0, UNet2's last layer
    x 0.15 with bias 0, and each SE block's first 1x1 conv x 10."""
    g = torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))
    p = {}
    for key, kind, ci, co in LAYERS:
        k = _K[kind]
        transposed = kind in ("up", "up4")
        shape = (ci, co, k, k) if transposed else (co, ci, k, k)
        fan_in = ci * (k // 2) ** 2 if transposed else ci * k * k
        std = (2.0 / (fan_in * (1 + LEAKY ** 2))) ** 0.5
        p[f"{key}.weight"] = torch.randn(shape, generator=g) * std
        p[f"{key}.bias"] = torch.randn((co,), generator=g) * 0.01
    for key in ("unet1.conv1.conv.0", "unet1.conv1.conv.2", "unet1.conv3"):
        w = p[f"{key}.weight"]
        for c in range(3):
            w[c] *= 0.02
            w[c, c, 1, 1] = 1.0
        p[f"{key}.bias"][:3] = 0.0
    p["unet1.conv2_up.weight"][:, :3] *= 0.1
    p["unet1.conv2_up.bias"][:3] = 0.0
    w = p["unet1.conv_bottom.weight"]
    w *= 0.02
    tent = torch.tensor([0.25, 0.75, 0.75, 0.25])
    for c in range(3):
        w[c, c] = tent[:, None] * tent[None, :]
    p["unet1.conv_bottom.bias"].zero_()
    p["unet2.conv_bottom.weight"] *= 0.15
    for key in SE_GAINED:
        p[f"{key}.seblock.conv1.weight"] *= 10.0
    p["unet2.conv_bottom.bias"].zero_()
    return p


def weights(stack: dict, root=None, device=None) -> dict:
    """The stack's parameters, drawn from its `seed` by init_params (no
    trained UpCUNet weights are in the repository), and its `tile` side:
    {"params": state_dict key -> f32 CPU tensor, "tile": S}."""
    tile = int(stack["tile"])
    if tile % 2 or tile < 74:
        raise ValueError(f"tile {tile}: an even side of at least 74")
    return {"params": init_params(stack["seed"]), "tile": tile}


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
    """f32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """f32 -> float8 e4m3 and back, scaled so that the largest |x| over
    `dims` maps to 448."""
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _leaky(x):
    return torch.where(x < 0, x * LEAKY, x)


class _Net:
    """UpCUNet's forward pass over a batch of tiles [T, 3, S, S] f32."""

    def __init__(self, params: dict, device, precision: str):
        self.p = {k: v.to(device, torch.float32) for k, v in params.items()}
        self.prec = precision

    def conv(self, x, key, kind):
        w, b = self.p[f"{key}.weight"], self.p[f"{key}.bias"]
        if self.prec == "tf32":
            x, w = round_tf32(x), round_tf32(w)
        elif self.prec == "fp8":
            x = round_fp8(x, None)
            w = round_fp8(w, (0, 2, 3) if kind in ("up", "up4")
                          else (1, 2, 3))
        elif self.prec != "f32":
            raise ValueError(f"unknown precision {self.prec!r}")
        if kind == "dn":
            return F.conv2d(x, w, b, stride=2)
        if kind == "up":
            return F.conv_transpose2d(x, w, b, stride=2)
        if kind == "up4":
            return F.conv_transpose2d(x, w, b, stride=2, padding=3)
        return F.conv2d(x, w, b)

    def unetconv(self, x, key):
        _, _, _, se = _UC[key]
        x = _leaky(self.conv(x, f"{key}.conv.0", "c3"))
        x = _leaky(self.conv(x, f"{key}.conv.2", "c3"))
        if se:
            z = x.mean(dim=(2, 3), keepdim=True)
            z = torch.relu(self.conv(z, f"{key}.seblock.conv1", "s1"))
            z = torch.sigmoid(self.conv(z, f"{key}.seblock.conv2", "s2"))
            x = x * z
        return x

    def unet1(self, x):
        x1 = self.unetconv(x, "unet1.conv1")
        x2 = _leaky(self.conv(x1, "unet1.conv1_down", "dn"))
        x2 = self.unetconv(x2, "unet1.conv2")
        x2 = _leaky(self.conv(x2, "unet1.conv2_up", "up"))
        x3 = _leaky(self.conv(_crop(x1, 4) + x2, "unet1.conv3", "c3"))
        return self.conv(x3, "unet1.conv_bottom", "up4")

    def unet2(self, x):
        x1 = self.unetconv(x, "unet2.conv1")
        x2 = _leaky(self.conv(x1, "unet2.conv1_down", "dn"))
        x2 = self.unetconv(x2, "unet2.conv2")
        x3 = _leaky(self.conv(x2, "unet2.conv2_down", "dn"))
        x3 = self.unetconv(x3, "unet2.conv3")
        x3 = _leaky(self.conv(x3, "unet2.conv3_up", "up"))
        x4 = self.unetconv(_crop(x2, 4) + x3, "unet2.conv4")
        x4 = _leaky(self.conv(x4, "unet2.conv4_up", "up"))
        x5 = _leaky(self.conv(_crop(x1, 16) + x4, "unet2.conv5", "c3"))
        return self.conv(x5, "unet2.conv_bottom", "c3")

    def __call__(self, x):
        a = self.unet1(x)
        return torch.clamp(self.unet2(a) + _crop(a, 20), 0.0, 1.0)


def _crop(x, n):
    return x[:, :, n:x.shape[2] - n, n:x.shape[3] - n]


def upscale(rgb: torch.Tensor, params: dict, tile: int,
            precision: str = "f32") -> torch.Tensor:
    """f32 RGB in [0, 1], [N, h, w, 3] -> f32 [N, 2h, 2w, 3] in [0, 1]: the
    tiling of steps 2-4 above, before the u8 map."""
    n, h, w, _ = rgb.shape
    step = tile - 2 * HALO
    ny, nx = -(-h // step), -(-w // step)
    out_t = 2 * step
    net = _Net(params, rgb.device, precision)
    x = F.pad(rgb.permute(0, 3, 1, 2),
              (HALO, HALO + nx * step - w, HALO, HALO + ny * step - h),
              mode="replicate")
    out = torch.empty((n, 3, ny * out_t, nx * out_t), device=rgb.device)
    with exact_f32():
        for i in range(n):
            for ty in range(ny):   # a row of tiles a call, each its own
                row = torch.cat([x[i:i + 1, :, ty * step:ty * step + tile,
                                   tx * step:tx * step + tile]
                                 for tx in range(nx)])
                for tx, t in enumerate(net(row)):
                    out[i, :, ty * out_t:(ty + 1) * out_t,
                        tx * out_t:(tx + 1) * out_t] = t
    return out[:, :, :2 * h, :2 * w].permute(0, 2, 3, 1)


def convert(bgr_u8: torch.Tensor, params: dict, tile: int,
            precision: str = "f32") -> torch.Tensor:
    """u8 BGR [N, h, w, 3] -> u8 BGR [N, 2h, 2w, 3]."""
    rgb = bgr_u8.flip(-1).to(torch.float32) / 255.0
    y = upscale(rgb, params, tile, precision)
    u8 = torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8)
    return u8.flip(-1).contiguous()


def convert_by_role(bgr_u8: torch.Tensor, layers: dict, precisions=None):
    """`convert` with the model of role "upcunet" (`weights`' dict) ->
    (u8 BGR frames, None: there is no plane a chain hands on)."""
    w = layers["upcunet"]
    prec = (precisions or {}).get("upcunet", "f32")
    return convert(bgr_u8, w["params"], w["tile"], prec), None
