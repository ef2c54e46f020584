"""UpCUNet's forward pass over a batch of tiles (models/cunet.py states the
model): its 3x3 layers of widths 32 -> 64, 64 -> 64, 64 -> 128 and
128 -> 64 on csrc/mma.cu (ops/stack.py:conv3x3_mma, keyed by the widths),
the rest on library calls with their epilogue on csrc/epi.cu
(cunet_epilogue), the squeeze-and-excitation blocks, the crops and the skip
adds.

The precision policy of the bf16 model (the product's): activations are
bf16 NHWC between layers; every convolution sums in f32. csrc/mma.cu adds
its f32 bias and applies LeakyReLU in f32 before one rounding to bf16. The
library layers (3 -> 32, 128 -> 256, 256 -> 128 and the two 64 -> 3 3x3
and 4x4 ones; the 2x2 stride-2 and transposed convolutions) run as cuDNN
bf16 convolutions, channels-last, with no bias; csrc/epi.cu then adds the
bias (rounded to bf16) to the bf16 result, applies LeakyReLU and, after the
three transposed 2x2 layers, adds the cropped skip, in one pass that rounds
each of the three steps to bf16 as PyTorch's bias add, F.leaky_relu and
skip add did (bit for bit). An SE block takes the tile's mean of each
channel in f32, its two 1x1 products, ReLU and sigmoid in f32 (TF32 off),
and scales the bf16 activation by the f32 vector with one rounding.
UNet2's output and crop20 of UNet1's are added in f32, clamped to [0, 1],
scaled by 255 and rounded half to even to u8. The f32 model (dtype float32) runs every layer as an f32 library
convolution with TF32 off, its bias in the library call, LeakyReLU and the
skip adds in PyTorch.

On the CPU the same arithmetic runs in plain PyTorch: csrc/mma.cu's layers
as mma_layer_plain, the library layers as f32 convolutions of the bf16
values rounded to bf16, their epilogue as cunet_epilogue_plain.

Spans (utils/trace.py): "w2x.cunet.unet1", "w2x.cunet.unet2" around each
U-Net, "w2x.cunet.se" around each SE block (`channels`), "w2x.cunet.epi"
around each library layer's epilogue (`mode`, `channels`), and csrc/mma.cu's
layers' "w2x.stack" (kind "cunet", `ci`, `co`, `route`) from conv3x3_mma.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from waifu2x_torch.models import cunet
from waifu2x_torch.ops.convstack import no_tf32
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import pack_mma
from waifu2x_torch.ops.stack import conv3x3_mma, has_mma
from waifu2x_torch.utils import trace

LEAKY = cunet.LEAKY
RESIDUAL_CROP = 20   # UNet1's output is 40 pixels wider than UNet2's
EPI_CHANNELS = (3, 32, 64, 128, 256)   # the widths csrc/epi.cu takes
# csrc/epi.cu's launches by mode (epi_mode); a bf16 forward pass makes 7
# "bias_leaky", 3 "bias_leaky_skip" and 2 "bias" a chunk of tiles
EPI_LAUNCHES = {"bias": 0, "bias_leaky": 0, "bias_skip": 0,
                "bias_leaky_skip": 0}


@dataclasses.dataclass
class CunetModel:
    """Device-ready UpCUNet weights for one tile size and storage dtype.

    tile:  input pixels a side of a tile (even; the SE means are over it)
    dtype: bfloat16 (the product) or float32
    mma:   3x3 layer key -> (pack_mma(w) bf16, b f32) for the layers that
           run on csrc/mma.cu (bf16 models, stack.has_mma)
    conv:  every other convolution's key -> (w in the dtype, channels-last,
           b in the dtype), in PyTorch's layouts
    se:    SE block key -> (W1 [o, o/8], b1, W2 [o/8, o], b2), f32
    """

    tile: int
    dtype: torch.dtype
    mma: dict
    conv: dict
    se: dict

    @classmethod
    def build(cls, params: dict, dtype=torch.bfloat16, device="cuda",
              tile: int = 436) -> "CunetModel":
        """From models/cunet.py's parameters (nunif's state_dict names)."""
        cunet.validate_params(params)
        cunet.check_tile(tile)
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"an UpCUNet model runs bf16 or f32, not {dtype}")
        dev = torch.device(device)
        with trace.span("w2x.setup.prep", dtype=dtype, arch="upcunet"):
            mma, conv, se = {}, {}, {}
            for layer in cunet.LAYERS:
                w = params[f"{layer.key}.weight"].detach().float()
                b = params[f"{layer.key}.bias"].detach().float()
                if layer.kind in ("se1", "se2"):
                    blk = layer.key.rsplit(".", 2)[0]
                    se.setdefault(blk, []).extend(
                        [w[:, :, 0, 0].t().contiguous().to(dev),
                         b.to(dev)])
                elif (dtype == torch.bfloat16 and layer.kind == "conv3"
                      and has_mma(layer.cin, layer.cout)):
                    mma[layer.key] = (
                        pack_mma(w.permute(2, 3, 1, 0)).to(dev, dtype)
                        .contiguous(), b.to(dev))
                else:
                    conv[layer.key] = (
                        w.to(dev, dtype).contiguous(
                            memory_format=torch.channels_last),
                        b.to(dev, dtype))
            se = {k: tuple(v) for k, v in se.items()}
            return cls(tile, dtype, mma, conv, se)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def epi_mode(leaky: bool, skip: bool) -> str:
    """EPI_LAUNCHES' key of an epilogue."""
    return "bias" + "_leaky" * bool(leaky) + "_skip" * bool(skip)


def reset_epi_launches() -> None:
    for mode in EPI_LAUNCHES:
        EPI_LAUNCHES[mode] = 0


def cunet_epilogue_plain(y: torch.Tensor, b: torch.Tensor, leaky: bool,
                         skip: "torch.Tensor | None" = None,
                         crop: int = 0) -> torch.Tensor:
    """cunet_epilogue's arithmetic in PyTorch, as a new tensor: the bias
    added and rounded to y's dtype, LeakyReLU in f32 rounded, crop_crop(skip)
    added in f32 and rounded."""
    t = (y.float() + b.float()).to(y.dtype)
    if leaky:
        t = torch.where(t > 0, t, (t.float() * LEAKY).to(y.dtype))
    if skip is not None:
        s = skip[:, crop:skip.shape[1] - crop, crop:skip.shape[2] - crop]
        t = (s.float() + t.float()).to(y.dtype)
    return t


def cunet_epilogue(y: torch.Tensor, b: torch.Tensor, leaky: bool,
                   skip: "torch.Tensor | None" = None,
                   crop: int = 0) -> torch.Tensor:
    """A library convolution's epilogue, in place on its output y [T, h, w,
    C] (bf16 NHWC, contiguous, computed without the bias): y = crop_crop(
    skip) + leaky(y + b), each of the three steps rounded to bf16, as the
    bias add of PyTorch's cuDNN route, F.leaky_relu and crop_add round them.
    b [C] bf16; skip, where given, [T, h + 2 crop, w + 2 crop, C] bf16
    contiguous; C one of EPI_CHANNELS. CPU tensors take cunet_epilogue_plain;
    CUDA tensors one launch of csrc/epi.cu's cunet_epilogue, counted in
    EPI_LAUNCHES by mode. A "w2x.cunet.epi" span (mode, channels) holds the
    call. Returns y."""
    if y.dim() != 4 or y.shape[3] not in EPI_CHANNELS:
        raise ValueError(f"the epilogue takes y [T, h, w, C], C in "
                         f"{EPI_CHANNELS}, got {tuple(y.shape)}")
    n, h, w, c = y.shape
    if y.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or (
            skip is not None and skip.dtype != torch.bfloat16):
        raise TypeError("the epilogue runs bf16 y, b and skip")
    if not (y.is_contiguous() and b.is_contiguous()) or tuple(b.shape) != (
            c,) or b.device != y.device:
        raise ValueError(f"y and b [{c}] must be contiguous, on {y.device}")
    if skip is None and crop:
        raise ValueError("a crop needs a skip")
    if skip is not None and (
            tuple(skip.shape) != (n, h + 2 * crop, w + 2 * crop, c)
            or crop < 0 or not skip.is_contiguous()
            or skip.device != y.device):
        raise ValueError(f"skip must be contiguous [{n}, {h + 2 * crop}, "
                         f"{w + 2 * crop}, {c}] on {y.device}, got "
                         f"{tuple(skip.shape)}")
    mode = epi_mode(leaky, skip is not None)
    with trace.span("w2x.cunet.epi", on=y, mode=mode, channels=c):
        if y.device.type == "cpu":
            return y.copy_(cunet_epilogue_plain(y, b, leaky, skip, crop))
        with torch.cuda.device(y.device):
            stack._Launcher(None, y, None).run(
                "epi", "w2x_cunet_epilogue", f"epilogue {mode}, C = {c}",
                None, y.data_ptr(), b.data_ptr(),
                None if skip is None else skip.data_ptr(), n, h, w, c, crop,
                int(bool(leaky)))
        EPI_LAUNCHES[mode] += 1
    return y


def _library(x: torch.Tensor, model: CunetModel, key: str, leaky: bool,
             skip: "torch.Tensor | None" = None,
             crop: int = 0) -> torch.Tensor:
    """One library convolution (models/cunet.py's kind of `key`) on NHWC
    x -> NHWC, with LeakyReLU where `leaky` and crop_crop(skip) added where
    a skip is given. A bf16 model runs the convolution without its bias and
    the rest in cunet_epilogue; an f32 model the bias in the convolution,
    F.leaky_relu and crop_add."""
    w, b = model.conv[key]
    kind = cunet.BY_KEY[key].kind
    kw = {"down": {"stride": 2}, "up": {"stride": 2},
          "up4": {"stride": 2, "padding": 3}}.get(kind, {})
    op = F.conv_transpose2d if kind in ("up", "up4") else F.conv2d
    xin = _nchw(x)
    bf16 = x.dtype == torch.bfloat16
    with no_tf32():
        if x.device.type == "cpu" and bf16:
            # the card's arithmetic: f32 sums rounded to bf16
            y = op(xin.float(), w.float(), None, **kw).to(x.dtype)
        else:
            y = op(xin, w, None if bf16 else b, **kw)
    y = _nhwc(y)
    if bf16:
        return cunet_epilogue(y, b, leaky, skip, crop)
    if leaky:
        y = F.leaky_relu(y, LEAKY)
    return y if skip is None else crop_add(skip, crop, y)


def conv3(x: torch.Tensor, model: CunetModel, key: str,
          leaky: bool = True) -> torch.Tensor:
    """A 3x3 layer on NHWC x: csrc/mma.cu where the model holds its packed
    weights (bias and LeakyReLU in the kernel), else a library call."""
    if key in model.mma:
        return conv3x3_mma(x, *model.mma[key])
    return _library(x, model, key, leaky)


def squeeze_excite(x: torch.Tensor, model: CunetModel,
                   key: str) -> torch.Tensor:
    """SE block `key` on NHWC x [T, h, w, C]: each tile's channel means in
    f32, sigmoid(W2 relu(W1 z + b1) + b2) in f32, x scaled by it with one
    rounding to x's dtype."""
    w1, b1, w2, b2 = model.se[key]
    with trace.span("w2x.cunet.se", on=x, channels=x.shape[3]):
        z = torch.mean(x, dim=(1, 2), dtype=torch.float32)
        with no_tf32():
            z = torch.sigmoid(torch.relu(z @ w1 + b1) @ w2 + b2)
        out = torch.empty_like(x)
        return torch.mul(x, z[:, None, None, :], out=out)


def unetconv(x: torch.Tensor, model: CunetModel, key: str) -> torch.Tensor:
    x = conv3(conv3(x, model, f"{key}.conv.0"), model, f"{key}.conv.2")
    if key in model.se:
        x = squeeze_excite(x, model, key)
    return x


def crop_add(a: torch.Tensor, n: int, b: torch.Tensor) -> torch.Tensor:
    """crop_n(a) + b for NHWC a, b, rounded once to their dtype."""
    return torch.add(a[:, n:a.shape[1] - n, n:a.shape[2] - n], b,
                     out=torch.empty_like(b))


def unet1(x: torch.Tensor, model: CunetModel) -> torch.Tensor:
    with trace.span("w2x.cunet.unet1", on=x):
        x1 = unetconv(x, model, "unet1.conv1")
        x2 = _library(x1, model, "unet1.conv1_down", True)
        x2 = unetconv(x2, model, "unet1.conv2")
        x2 = _library(x2, model, "unet1.conv2_up", True, x1, 4)
        x3 = conv3(x2, model, "unet1.conv3")
        del x1, x2
        return _library(x3, model, "unet1.conv_bottom", False)


def unet2(x: torch.Tensor, model: CunetModel) -> torch.Tensor:
    with trace.span("w2x.cunet.unet2", on=x):
        x1 = unetconv(x, model, "unet2.conv1")
        x2 = _library(x1, model, "unet2.conv1_down", True)
        x2 = unetconv(x2, model, "unet2.conv2")
        x3 = _library(x2, model, "unet2.conv2_down", True)
        x3 = unetconv(x3, model, "unet2.conv3")
        x3 = _library(x3, model, "unet2.conv3_up", True, x2, 4)
        x4 = unetconv(x3, model, "unet2.conv4")
        del x2, x3
        x4 = _library(x4, model, "unet2.conv4_up", True, x1, 16)
        x5 = conv3(x4, model, "unet2.conv5")
        del x1, x4
        return conv3(x5, model, "unet2.conv_bottom", leaky=False)


def upcunet_tiles(x: torch.Tensor, model: CunetModel) -> torch.Tensor:
    """Tiles x [T, S, S, 3] RGB in [0, 1] (the model's dtype, NHWC) ->
    f32 RGB [T, 2S - 72, 2S - 72, 3]: clamp(UNet2(a) + crop20(a), 0, 1),
    the sum and the clamp in f32."""
    a = unet1(x, model)
    z = unet2(a, model)
    c = RESIDUAL_CROP
    y = a[:, c:a.shape[1] - c, c:a.shape[2] - c].float().add_(z)
    return y.clamp_(0.0, 1.0)


def upcunet_tiles_u8(x: torch.Tensor, model: CunetModel) -> torch.Tensor:
    """upcunet_tiles' result * 255, rounded half to even, as u8."""
    return upcunet_tiles(x, model).mul_(255.0).round_().to(torch.uint8)
