"""UpCUNet on the card, layer by layer and whole: holds csrc/mma.cu's
UpCUNet shapes (32 -> 64, 64 -> 64, 64 -> 128 on vgg_7's instances, and
128 -> 64) against their plain version at the widths and sizes of a batch
of 1080p frames, times each 3x3 layer shape on csrc/mma.cu or cuDNN and the
rest of the model's layer kinds, checks that vgg_7's scale stack still
makes its 7 launches (4 resident, 1 split) through the (ci, co) entry, and
times pipeline.upcunet2x_batch_u8 on 1080p batches with the launch counts
by (ci, co, route) of one dispatch.

    python3 -m waifu2x_torch.tools.cunet_probe [--frames 4] [--iters 5]

Prints one JSON object a line. Needs a CUDA card; --device cpu rehearses
at a small size on the host's clock (no device times).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from waifu2x_torch import pipeline as pl
from waifu2x_torch.models import cunet
from waifu2x_torch.ops import stack, unet
from waifu2x_torch.ops.convstack import no_tf32
from waifu2x_torch.ops.s2d import pack_mma
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line, time_ms

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def ulps(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(share of outputs that differ, largest difference in bf16 ulps at
    the larger magnitude, or where the terms cancel in the f32 sums' own
    spread, 1e-5 of the largest output)."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    ulp = ulp.clamp_min(1e-5 * r.abs().max().item())
    d = (g - r).abs()
    return (d > 0).float().mean().item(), (d / ulp).max().item()


def layer_checks(dev, n: int, side: int, iters: int) -> None:
    """Each csrc/mma.cu shape of UpCUNet at its largest plane in a tile of
    `side` pixels, n tiles: the kernel against mma_layer_plain, and its
    time against cuDNN's bf16 conv + LeakyReLU on the same input."""
    sides = cunet.layer_sides(side)
    g = torch.Generator(device=dev).manual_seed(11)
    best = {}
    for key, (s_in, _) in sides.items():
        k = cunet.BY_KEY[key]
        if k.kind != "conv3":
            continue
        shape = (k.cin, k.cout)
        if shape not in best or s_in > best[shape][1]:
            best[shape] = (key, s_in)
    for (ci, co), (key, s_in) in sorted(best.items()):
        x = torch.randn((n, s_in, s_in, ci), generator=g, device=dev).to(
            torch.bfloat16)
        w = torch.randn((co, ci, 3, 3), generator=g, device=dev) * (
            2.0 / (9 * ci)) ** 0.5
        b = torch.randn((co,), generator=g, device=dev) * 0.1
        flops = 2 * 9 * ci * co * n * (s_in - 2) ** 2
        nbytes = 2 * n * (ci * s_in ** 2 + co * (s_in - 2) ** 2)
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        xc = x.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bl = b.to(torch.bfloat16)
        lib = time_ms(lambda _: F.leaky_relu(F.conv2d(xc, wl, bl), 0.1),
                      dev, iters)
        row = {"what": "layer", "key": key, "ci": ci, "co": co,
               "shape": [n, s_in, s_in, ci], "bound_ms": bound,
               "cudnn_ms": lib}
        if stack.has_mma(ci, co):
            wp = pack_mma(w.permute(2, 3, 1, 0)).to(torch.bfloat16)
            stack.reset_launches()
            got = stack.conv3x3_mma(x[:2], wp, b)
            routes = {f"{a}>{c}:{r}": v
                      for (a, c, r), v in stack.MMA_SHAPES.items()}
            share, worst = ulps(got, stack.mma_layer_plain(x[:2], wp, b))
            ms = time_ms(lambda _: stack.conv3x3_mma(x, wp, b), dev, iters)
            row.update(mma_ms=ms, roofline_pct=100 * bound / ms,
                       differ=share, worst_ulps=worst, routes=routes,
                       ok=worst <= 1.0)
            if not row["ok"]:
                emit(**row)
                raise AssertionError(f"{ci} -> {co}: {worst} ulps")
        emit(**row)
        del x


def vgg_check(dev) -> None:
    """vgg_7's bf16 scale stack through the (ci, co) entry: 7 launches, 4
    resident and 1 split, and the persistent layers bit-equal to the tile
    kernel's on a 512^2 plane."""
    from waifu2x_torch.models.weights import load_model_json
    sp = stack.prep_params(load_model_json("models/scale2.0x_demo.json"),
                           torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    y = torch.rand((2, 512, 512), generator=g, device=dev).to(torch.bfloat16)
    stack.reset_launches()
    stack.stack_scale(y, sp)
    torch.cuda.synchronize(dev)
    counts = {"launches": stack.LAUNCHES,
              "resident": stack.MID_LAUNCHES["mma_resident"],
              "split": stack.MID_LAUNCHES["mma_split"],
              "shapes": {f"{a}>{c}:{r}": v
                         for (a, c, r), v in stack.MMA_SHAPES.items()}}
    equal = {}
    for k in range(2, 7):
        x = torch.randn((2, 100, 130, stack.WIDTHS[k - 1][0]), generator=g,
                        device=dev).to(torch.bfloat16)
        equal[k] = torch.equal(stack.mma_layer(x, sp, k),
                               stack.mma_layer(x, sp, k, persistent=False))
    ok = (counts["launches"], counts["resident"], counts["split"]) == (
        7, 4, 1) and all(equal.values())
    emit(what="vgg7", **counts, persistent_equals_tile=equal, ok=ok)
    if not ok:
        raise AssertionError("vgg_7's stack changed")


def step_times(dev, frames: int, iters: int, h: int, w: int) -> None:
    """upcunet2x_batch_u8 on `frames` seeded h x w frames: its device time a
    dispatch, the launches by (ci, co, route) of one, its output against
    the plain reference's on frame 0 (PSNR), and the same step's time in
    f32 (every layer on cuDNN, TF32 off)."""
    params = cunet.init_params(1)
    g = torch.Generator(device=dev).manual_seed(3)
    coarse = torch.rand((frames, 3, h // 32 + 1, w // 32 + 1), generator=g,
                        device=dev)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    bgr = torch.clamp(torch.round(img * 255 + 6 * torch.randn(
        img.shape, generator=g, device=dev)), 0, 255).to(torch.uint8)
    x = pl.unit_rgb(bgr)
    out_mp = frames * 4 * h * w / 1e6
    for dtype in (torch.bfloat16, torch.float32):
        model = unet.CunetModel.build(params, dtype, dev)
        stack.reset_launches()
        out = pl.upcunet2x_batch_u8(x, model)
        torch.cuda.synchronize(dev)
        shapes = {f"{a}>{c}:{r}": v
                  for (a, c, r), v in stack.MMA_SHAPES.items()}
        ms = time_ms(lambda _: pl.upcunet2x_batch_u8(x, model), dev, iters)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        emit(what="step", dtype=str(dtype), frames=frames, size=[h, w],
             tiles=frames * -(-h // 400) * -(-w // 400), ms=ms,
             mp_per_s=out_mp / ms * 1e3,
             shapes=shapes, peak_gb=peak)
        if dtype == torch.bfloat16:
            keep = out[:1].clone()
        del out, model
        torch.cuda.empty_cache()
    sys.path.insert(0, ".")
    from benchmark import harness
    ref = harness.load_module("benchmark/reference/upcunet.py")
    with no_tf32():
        r = ref.convert(bgr[:1], params, 436)
    mse = ((keep.float() - r.float()) ** 2).mean().item()
    emit(what="fidelity", psnr_db=10 * torch.log10(torch.tensor(
        255.0 ** 2 / max(mse, 1e-10))).item(),
        clamp_share=((r == 0) | (r == 255)).float().mean().item(),
        std_levels=r.float().std().item())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    emit(what="card", card=card_line(dev), torch=torch.__version__)
    if dev.type != "cuda":
        layer_checks(dev, 2, 76, 1)
        return 0
    vgg_check(dev)
    layer_checks(dev, 4 * args.frames * 15 // 4, 436, args.iters)
    step_times(dev, args.frames, args.iters, 1080, 1920)
    return 0


if __name__ == "__main__":
    sys.exit(main())
