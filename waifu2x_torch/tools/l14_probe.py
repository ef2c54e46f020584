"""Layers 1-4 of the stack, one at a time, at the truncation probe's grid
(the counterpart of the JAX package's tools/l14_probe.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width.
Modes, by the JAX names:
  xonly          the input fetch alone: the (64, 128, 16) tile of the
                 layer-1 im2col array and its right, lower and diagonal
                 stripes fetched a cell, out = ((tile + right[r, 0]) +
                 below[0, c]) + diag[0, 0], lanes 0-3, in f32 (ops/probe.py,
                 probe_fetch_map)
  upto1 .. 4     the stack stopped after layer k, 4 values of it per cell
                 (stack_scale_upto, upto k; the JAX body's quadrant-direct
                 layer 1 is the same function)
Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its delta to the mode before (upto1-4) and its bound.

    python3 -m waifu2x_torch.tools.l14_probe       # xonly upto1 .. upto4

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small --size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.tools.fused_strip_probe import (
    add_args, run_probe_variant, setup, stack_entry)
from waifu2x_torch.tools.layer_time_probe import print_ladder
from waifu2x_torch.utils.timing import card_line

MODES = ["xonly", "upto1", "upto2", "upto3", "upto4"]


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, MODES, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, g = setup(args, ap, MODES)
    print(f"l14_probe: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}", flush=True)
    ok = True
    if "xonly" in args.modes:
        ok = run_probe_variant("xonly", g, dev, args.iters, args.seed, rows)
    entries = [stack_entry(m, ylow, sp, int(m[-1]), "cell")
               for m in args.modes if m != "xonly"]
    print_ladder(entries, dev, args.iters, graph=True, rows=rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
