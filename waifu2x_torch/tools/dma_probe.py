"""Fetch and store prices of the layouts the stack's last layer and tails
use (the counterpart of the JAX package's tools/dma_probe.py,
dma_probe2.py and dma_probe3.py, as rounds 1, 2 and 3).

B = 4, grid (4, 8, 4) of (64, 128) cells; inputs [4, 576, 640, 16],
[4, 576, 80, 128] (the same bytes in 128-lane columns) and [4, 576, 640]
bf16. Every variant is a kernel of csrc/probe.cu, held against its plain
version and timed beside its bound, the plain version and one library call.
  round 1 (dma_probe.py:55, :157): lane16_x4 (the tile, its right, lower and
    diagonal stripes, summed into (64, 128, 4)), lane16_x1 (lanes 0-3 of the
    tile), lane128 and lane128_x4 (the same from 128-lane columns, each
    source pixel repeated 8 times), raw2d (the plane, 4 copies a pixel)
  round 2 (dma_probe2.py:50): out4, out128, out2d (zeros, no input),
    in16+o128, in128+o128, raw+o128 (a block fetched, the (64, 4, 128)
    zero block out), in16+o16c (the tile x 0 as u8). in16+o128 and
    raw+o128 do not trace in JAX (their values do not fit the output
    block); the port fetches the named block whole and writes zeros
  round 3 (dma_probe3.py:54): y4 and y512r (x 0.5 + 1 as (64, 128, 4) and
    the same bytes as (64, 512)), y512n (lanes 0-3 planar), u8_16 and
    u8_2048r (all 16 lanes x 255, rounded half to even, clipped, u8)

    python3 -m waifu2x_torch.tools.dma_probe            # rounds 1-3
    python3 -m waifu2x_torch.tools.dma_probe --round 2

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.ops import probe
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    probe.add_args(ap, batch=4)
    ap.add_argument("--round", type=int, choices=(1, 2, 3), default=None,
                    help="one round (default: all three)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = probe.grid_from_args(args, ap)
    ok = True
    for rnd in (args.round,) if args.round else (1, 2, 3):
        print(f"dma_probe round {rnd}: grid {(g.batch, g.ny, g.nx)} of "
              f"{(g.tr, g.tc)} cells; {card_line(dev)}", flush=True)
        ok = probe.run_variants(probe.TOOL_VARIANTS[f"dma_probe {rnd}"], g,
                                dev, args.iters, args.seed, rows) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
