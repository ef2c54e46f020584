"""The stack with its cell offsets forced to zero (the counterpart of the JAX
package's tools/shift_cost_probe.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width.
Modes, by the JAX names (each is ops/probe.py:shift_stack(ylow, sp, fx, fy)):
  base      fx = fy = 1: stack_scale's function and kernels (layer 7
            folded, csrc/l7.cu, as in the twins)
  noshiftx  fx = 0: the column offsets Dx of layers 2-7 forced to 0
  noshifty  fy = 0: the row offsets Dy forced to 0
  noshift   both
On a zeroed axis tap k of position p reads (p & ~1) | ((p + k) & 1), its own
s2d cell, where the stack reads p + k: the numbers are wrong by design.

What the deltas mean on this card: the JAX tool prices the relayout that a
column-shifted operand costs Mosaic. Here a shift costs nothing (a tap is a
descriptor offset into the staged window), and a twin reads p ^ 1, which no
descriptor reaches: csrc/mma.cu stages the window once more per zeroed axis
(three more copies for both) with that axis' pixel pairs swapped. Layer 7's
fold does the same work under every mask (its shift-sum reads another cell
of the same partial sums). So a twin's time minus base's is the price of
those copies, not of a shift.

Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its delta to base, its bound and the chunk plan of layers 2-6 that ran.

    python3 -m waifu2x_torch.tools.shift_cost_probe     # base noshiftx noshifty
    python3 -m waifu2x_torch.tools.shift_cost_probe base noshiftx noshifty noshift

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small --size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.ops import probe
from waifu2x_torch.tools.fused_strip_probe import add_args, setup
from waifu2x_torch.tools.layer_time_probe import bound_ms
from waifu2x_torch.utils.timing import card_line, time_ms

MODES = list(probe.SHIFT_MODES)
DEFAULT = ["base", "noshiftx", "noshifty"]


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, DEFAULT, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, _ = setup(args, ap, MODES)
    print(f"shift_cost_probe: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}; a twin's delta is the price of its swapped "
          f"window copies, not of a shift", flush=True)
    bound, by = bound_ms(ylow, 7)
    base = None
    for mode in args.modes:
        fx, fy = probe.SHIFT_MODES[mode]
        zs = probe.shift_zs(fx, fy)
        ms = time_ms(lambda _: probe.shift_stack(ylow, sp, fx, fy), dev,
                     args.iters, graph=True)
        plans = probe.variant_plans(zs)
        line = f"{mode:>10}: {ms:9.3f} ms per {args.batch}x{args.size}^2"
        if base is not None and mode != "base":
            line += f"  delta {ms - base:+9.3f} ms"
        print(f"{line}  bound {bound:.3f} ms by {by}  zero-shift mask {zs}, "
              f"layers 2-6 kc x stages: {plans}", flush=True)
        if mode == "base":
            base = ms
        if rows is not None:
            rows.append({"mode": mode, "ms": ms, "zs": zs, "bound_ms": bound,
                         "bound_by": by, "plans": plans,
                         "delta_ms": None if base is None or mode == "base"
                         else ms - base})
    return 0


if __name__ == "__main__":
    sys.exit(main())
