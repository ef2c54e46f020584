"""Fidelity and step time of the int8 layer-6 path (the counterpart of the
JAX package's tools/i8_fidelity_probe.py, without cv2).

For one weight file it measures, on structured frames drawn from --seed:
  1. PSNR of the scale step's u8 output (scale2x_batch_u8_fused, bf16
     kernel, 512 x 512 frames) against the port's f32 non-kernel path
     (scale2x_batch), with layer 6 direct and with layer 6 as int8
     (ops.stack.L6_I8, the W2X_L6_I8 switch);
  2. the training-side proxy of the same gap, train.qat.l6_quant_gap_db,
     on the frames' padded Y planes;
  3. the step's time at the scale512 shape (--batch frames of 512 x 512)
     with each form, by CUDA events.

    python3 -m waifu2x_torch.tools.i8_fidelity_probe [--model path.json]

Needs a CUDA card. --device cpu --size 32 --skip_throughput rehearses the
fidelity half with the plain versions at a small size.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_torch.config import Config
from waifu2x_torch.models.srcnn import SRCNN
from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import d2s_host_cmajor
from waifu2x_torch.pipeline import (
    FastStack,
    _to_bgr_u8,
    _to_yuv,
    resolve_device,
    scale2x_batch,
    scale2x_batch_u8_fused,
)
from waifu2x_torch.train.qat import l6_quant_gap_db

DEFAULT_MODEL = (Path(__file__).resolve().parents[2] / "models"
                 / "scale2.0x_demo.json")


def structured_batch(rng: np.random.Generator, n: int, h: int,
                     w: int) -> np.ndarray:
    """Structured u8 BGR frames: smooth gradients, ten filled discs and
    rectangles in random colours, mild sensor noise (the content class the
    fidelity bar is stated on; pure-random frames are the adversarial
    case)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        img = np.stack([
            128 + 90 * np.sin(xx / 37.0) * np.cos(yy / 53.0),
            128 + 80 * np.cos((xx + yy) / 61.0),
            128 + 70 * np.sin(yy / 29.0),
        ], axis=-1)
        for k in range(10):
            cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
            col = rng.integers(0, 256, 3).astype(np.float32)
            if k % 2:
                r = int(rng.integers(min(8, h // 6), max(h // 6, 9)))
                # a soft one-pixel rim, as an anti-aliased disc has
                cover = np.clip(r + 0.5 - np.hypot(xx - cx, yy - cy), 0, 1)
            else:
                x2, y2 = int(rng.integers(0, w)), int(rng.integers(0, h))
                cover = ((xx >= min(cx, x2)) & (xx <= max(cx, x2))
                         & (yy >= min(cy, y2)) & (yy <= max(cy, y2))
                         ).astype(np.float32)
            img = img * (1 - cover[..., None]) + col * cover[..., None]
        img = img + rng.normal(0, 2.0, img.shape)
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def _psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse else float("inf")


def _step_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=str(DEFAULT_MODEL))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--skip_throughput", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params = load_model_json(args.model)
    rng = np.random.default_rng(args.seed)
    imgs = structured_batch(rng, 2, args.size, args.size)
    yuv = _to_yuv(torch.from_numpy(imgs).to(dev))
    model32 = SRCNN.from_params(params).to(dev)
    ref = _to_bgr_u8(scale2x_batch(
        yuv, model32, Config(mode="scale", compute_dtype="float32"))
    ).cpu().numpy()
    fast = FastStack.build(params, scale_input=True, dtype=torch.bfloat16,
                           device=dev)

    def with_i8(flag: bool, fn):
        old = stack.L6_I8
        stack.L6_I8 = flag
        try:
            return fn()
        finally:
            stack.L6_I8 = old

    def kernel_psnr(flag: bool) -> float:
        got = with_i8(flag, lambda: scale2x_batch_u8_fused(yuv, fast))
        return _psnr_u8(d2s_host_cmajor(got.cpu().numpy()), ref)

    where = "the plain versions on the CPU"
    if dev.type == "cuda":
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(f"model {args.model}, 2 structured {args.size} x {args.size} "
          f"frames, seed {args.seed}, on {where}", flush=True)
    print(f"  bf16 kernel path, layer 6 direct, vs f32 non-kernel path: "
          f"{kernel_psnr(False):.2f} dB", flush=True)
    print(f"  bf16 kernel path, layer 6 int8 (tile "
          f"{stack.default_tile(args.size, args.size)}), vs f32 non-kernel "
          f"path: {kernel_psnr(True):.2f} dB", flush=True)
    crop = min(256, args.size + 14)
    ypad = F.pad(yuv[..., 0][:, None].cpu(), (7,) * 4, mode="replicate")
    ypad = ypad[:, 0, :crop, :crop, None].contiguous()
    print(f"  qat-proxy layer-6 quantisation gap "
          f"(train.qat.l6_quant_gap_db): "
          f"{l6_quant_gap_db(params, ypad):.2f} dB", flush=True)

    if args.skip_throughput:
        return 0
    if dev.type != "cuda":
        print("  step times need a CUDA card: not measured", flush=True)
        return 0
    big = torch.from_numpy(rng.random(
        (args.batch, args.size, args.size, 3), dtype=np.float32)).to(dev)
    mp = args.batch * 4 * args.size * args.size / 1e6
    for name, flag in (("direct", False), ("int8", True)):
        ms = with_i8(flag, lambda: _step_ms(
            lambda: scale2x_batch_u8_fused(big, fast), args.iters))
        print(f"  scale step, {args.batch} x {args.size}^2, layer 6 {name}: "
              f"{ms:.2f} ms/batch = {mp / ms * 1e3:.1f} output MP/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
