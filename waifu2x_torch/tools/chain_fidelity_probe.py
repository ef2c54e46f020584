"""Fidelity of the noise -> scale chain by stack dtype (the counterpart of
the JAX package's tools/chain_fidelity_probe.py).

On a seeded pure-random u8 BGR image (every pixel an edge: the adversarial
case for bf16 storage), the shipped noise1_demo and scale2.0x_demo weights
run through the two kernel stacks (FastStack.build(..., dtype=)) as a
noise_batch_fast -> scale2x_batch_fast chain in four dtype pairs, and each
chain's u8 output is held against the f32 non-kernel Converter
(F.conv2d, TF32 off) in PSNR:

  bf/bf     noise bf16 -> scale bf16
  f32/bf    noise f32  -> scale bf16   (the Converter's compute_dtype auto)
  bf/f32    noise bf16 -> scale f32
  f32/f32   noise f32  -> scale f32

    python -m waifu2x_torch.tools.chain_fidelity_probe [--size 512]

--device cpu runs the kernels' plain versions (rehearse at --size 32).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from waifu2x_torch.config import Config
from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.pipeline import (
    Converter,
    FastStack,
    _to_bgr_u8,
    _to_yuv,
    noise_batch_fast,
    resolve_device,
    scale2x_batch_fast,
)
from waifu2x_torch.utils.metrics import psnr
from waifu2x_torch.utils.timing import card_line

MODELS = Path(__file__).resolve().parents[2] / "models"
CHAINS = (("bf/bf", torch.bfloat16, torch.bfloat16),
          ("f32/bf", torch.float32, torch.bfloat16),
          ("bf/f32", torch.bfloat16, torch.float32),
          ("f32/f32", torch.float32, torch.float32))


def run(size: int, dev: torch.device, seed: int = 0) -> dict:
    """{chain name: PSNR (dB) of its u8 output against the f32 non-kernel
    chain} on a seeded size x size random image."""
    img = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               dtype=np.uint8)
    noise_p = load_model_json(MODELS / "noise1_demo.json")
    scale_p = load_model_json(MODELS / "scale2.0x_demo.json")
    ref = Converter.from_params(
        Config(mode="noise_scale", compute_dtype="float32", use_pallas=False),
        noise_p, scale_p, dev).process_bgr_u8(img)
    yuv = _to_yuv(torch.from_numpy(img[None]).to(dev))
    out = {}
    for name, dn, ds in CHAINS:
        fn = FastStack.build(noise_p, False, dn, dev)
        fs = FastStack.build(scale_p, True, ds, dev)
        got = _to_bgr_u8(scale2x_batch_fast(noise_batch_fast(yuv, fn),
                                            fs))[0].cpu().numpy()
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: {got.shape} != {ref.shape}")
        out[name] = psnr(got, ref)
    return out


def main(argv=None, results=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dbs = run(args.size, dev, args.seed)
    print(f"noise1 -> scale2x chain on a pure-random {args.size}^2 u8 image "
          f"(seed {args.seed}) against the f32 non-kernel chain; "
          f"{card_line(dev)}", flush=True)
    for name, db in dbs.items():
        print(f"  {name:8s}: {db:6.2f} dB", flush=True)
    if results is not None:
        results.append(dbs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
