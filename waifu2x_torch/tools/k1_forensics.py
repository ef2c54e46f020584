"""The stack stopped after layer k with layer k's activation written whole
(the counterpart of the JAX package's tools/k1_forensics.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width.
Modes, by the JAX names:
  0        the low-res input window, the plane edge-padded by 4
           (stack_scale_upto, upto 0, out="whole": one upto_gather launch)
  1 .. 4   layer k's activation plane [N, 2h+14-2k, 2w+14-2k, C_k], halo
           and all (out="whole": the buffer that layer k's launch wrote)
  5, 6     layer 4 with its K split to 128 and with its 256 lanes split in
           two: Mosaic schedules of mode 4's function with no Hopper
           counterpart (the tensor-core layer's K loop already runs in
           slices of channels), so the tool runs mode 4's kernels and says so
Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its delta to the mode before (0-4) and its bound.

    python3 -m waifu2x_torch.tools.k1_forensics             # 4 6, as JAX
    python3 -m waifu2x_torch.tools.k1_forensics 0 1 2 3 4 5 6

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small --size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.tools.fused_strip_probe import add_args, setup, stack_entry
from waifu2x_torch.tools.layer_time_probe import print_ladder
from waifu2x_torch.utils.timing import card_line

MODES = ["0", "1", "2", "3", "4", "5", "6"]
DEFAULT = ["4", "6"]
LABELS = {4: "+L4 (full K1)", 5: "+L4 K split", 6: "+L4 a-split"}


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, DEFAULT, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, _ = setup(args, ap, MODES)
    print(f"k1_forensics: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}", flush=True)
    entries = []
    for mode in args.modes:
        k = int(mode)
        note = ("a Mosaic schedule of mode 4: ran mode 4's kernels"
                if k > 4 else "")
        entries.append(stack_entry(LABELS.get(k, f"upto{k}"), ylow, sp,
                                   min(k, 4), "whole", note, k <= 4))
    print_ladder(entries, dev, args.iters, graph=True, rows=rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
