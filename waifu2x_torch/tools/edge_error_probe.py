"""Where the bf16 scale step's error lies in the plane (the counterpart of
the JAX package's tools/edge_error_probe.py).

The fused 2x scale step (FastStack.scale, the bf16 kernel stack, d2s'd)
and the f32 reference (nearest-2x, then the F.conv2d stack with TF32 off,
ops.convstack.convert_plane) run on a pure-random low-res plane with
init_params(0)'s weights; the tool prints the Y-plane RMS error (in u8
levels) binned by distance to the nearest image edge, and the PSNR the
plane would have if a border ring of N px were exact.

    python -m waifu2x_torch.tools.edge_error_probe [--size 512]

--device cpu runs the plain versions (rehearse at --size 16).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops.convstack import convert_plane
from waifu2x_torch.ops.resize import NEAREST, resize
from waifu2x_torch.ops.s2d import d2s
from waifu2x_torch.pipeline import FastStack, resolve_device
from waifu2x_torch.utils.timing import card_line

BINS = ((0, 1), (1, 2), (2, 4), (4, 8), (8, 16), (16, 32), (32, 64),
        (64, 10 ** 9))
BORDERS = (0, 2, 4, 8, 16, 32)


def run(size: int, dev: torch.device, seed: int = 0) -> dict:
    """The error of the bf16 step against f32 at output size 2 * size:
    overall rms and PSNR (255 peak), rms and max by edge-distance bin, and
    the PSNR with each border ring exact."""
    params = init_params(0)
    fast = FastStack.build(params, True, torch.bfloat16, dev)
    ylow = torch.from_numpy(np.random.default_rng(seed).random(
        (size, size), np.float32)).to(dev)
    ref = convert_plane(resize(ylow, (2 * size, 2 * size), NEAREST),
                        tuple({k: v.to(dev) for k, v in p.items()}
                              for p in params))
    got = d2s(fast.scale(ylow[None]).float())[0, :, :, 0]
    if got.shape != ref.shape:
        raise AssertionError(f"{tuple(got.shape)} != {tuple(ref.shape)}")
    err = (got.double() - ref.double()).cpu().numpy() * 255.0
    h = 2 * size
    iy, ix = np.mgrid[0:h, 0:h]
    d = np.minimum(np.minimum(iy, ix), np.minimum(h - 1 - iy, h - 1 - ix))
    mse = np.mean(err ** 2)
    out = {"size": h, "rms": float(np.sqrt(mse)),
           "psnr": float(10 * np.log10(255 ** 2 / mse)), "bins": [],
           "border_psnr": {}}
    for lo, hi in BINS:
        m = (d >= lo) & (d < hi)
        if m.any():
            out["bins"].append((lo, min(hi, h), float(np.sqrt(np.mean(
                err[m] ** 2))), float(np.abs(err[m]).max())))
    for b in BORDERS:
        m = d >= b
        if m.any():
            out["border_psnr"][b] = float(
                10 * np.log10(255 ** 2 / np.mean(err[m] ** 2)))
    return out


def main(argv=None, results=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512,
                    help="low-res side; the output is twice that")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    r = run(args.size, dev, args.seed)
    print(f"size {r['size']}x{r['size']}, overall rms {r['rms']:.4f} "
          f"(PSNR {r['psnr']:.2f} dB); {card_line(dev)}", flush=True)
    for lo, hi, rms, mx in r["bins"]:
        print(f"  edge-dist [{lo:3d},{hi:3d}): rms {rms:8.4f}  max "
              f"{mx:8.3f}", flush=True)
    for b, db in r["border_psnr"].items():
        print(f"  if border {b:2d} px were exact: PSNR {db:.2f} dB",
              flush=True)
    if results is not None:
        results.append(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
