"""Store and fetch prices at the scale512 grid, beside the production
stages (the counterpart of the JAX package's tools/stage_time.py).

Batch 16 x 512^2, tile (64, 128), grid (16, 8, 4). The probes, under the JAX
script's names (its printed label in brackets), each a kernel of
csrc/probe.cu held against its plain version and timed:
  c4 (outonly)        a constant from a seed block to (64, 128, 4) bf16
  cd (outdense)       the same to the dense (64, 512) bf16 block
  out4f32, out16f32, out16u8   the same to 4/16-lane f32 and 16-lane u8
  cin1 (in16)         the (64, 128, 16) bf16 input block fetched whole, the
                      max of its 8 x 8 corner broadcast to the dense block
  cin4 (in16x4)       the tile and its right, lower and diagonal stripes
  ccat (outcat)       lanes 0-3 x 0.5, concatenated planar to (64, 512)
  cin9 (in9)          cin1 on the 9-lane block
  cin9mm (in9+l1)     the 9-lane block times a (9, 128) weight into a
                      (64, 128, 128) bf16 scratch, lanes 0-3 planar
Then the three production stages that the port has: kernel
(ops.stack.stack_scale alone), tail (pipeline._tail_u8_cmajor alone) and
step (pipeline.scale2x_batch_u8_fused), in ms per 4 frames as the JAX script
prints them. Its xcol stage has no counterpart: the port's layer 1 reads the
plane through an index map (ROADMAP.md, deliberate differences).

    python3 -m waifu2x_torch.tools.stage_time

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small size (--batch 1 --size 32 --tile 16 32 --iters 1);
those are no device times.
"""

from __future__ import annotations

import argparse
import sys

import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops import probe, stack
from waifu2x_torch.pipeline import (
    FastStack,
    _tail_u8_cmajor,
    resolve_device,
    scale2x_batch_u8_fused,
)
from waifu2x_torch.utils.timing import card_line, time_ms


def stages(g: probe.Grid, dev: torch.device, iters: int, seed: int) -> dict:
    """ms per batch of the production stages on seeded YUV frames and a
    stack of random bf16 weights."""
    size = g.ny * g.tr
    fast = FastStack.build(init_params(seed), True, dtype=torch.bfloat16,
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    yuv = torch.rand((g.batch, size, size, 3), generator=gen, device=dev)
    ylow = yuv[..., 0].to(torch.bfloat16).contiguous()
    y_s2d = stack.stack_scale(ylow, fast.sp)
    return {name: time_ms(fn, dev, iters) for name, fn in (
        ("kernel", lambda k: stack.stack_scale(ylow, fast.sp)),
        ("tail", lambda k: _tail_u8_cmajor(y_s2d, yuv)),
        ("step", lambda k: scale2x_batch_u8_fused(yuv, fast)))}


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    probe.add_args(ap, batch=16)
    ap.add_argument("--stage_iters", type=int, default=5,
                    help="timed runs of each production stage")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = probe.grid_from_args(args, ap)
    print(f"stage_time: grid {(g.batch, g.ny, g.nx)} of {(g.tr, g.tc)} "
          f"cells; {card_line(dev)}", flush=True)
    ok = probe.run_variants(probe.TOOL_VARIANTS["stage_time"], g, dev,
                            args.iters, args.seed, rows)
    clock = "" if dev.type == "cuda" else " (host clock)"
    for name, ms in stages(g, dev, args.stage_iters, args.seed).items():
        print(f"{name:9s}: {ms * 4 / g.batch:8.3f} ms/4f ({ms:.3f} ms per "
              f"batch of {g.batch}){clock}", flush=True)
    print("xcol     : no counterpart (layer 1 reads the plane through an "
          "index map)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
