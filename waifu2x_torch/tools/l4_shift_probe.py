"""Layer 4 after layers 1-3, its shifts zeroed or as scheduled (the
counterpart of the JAX package's tools/l4_shift_probe.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width.
Modes, by the JAX names (each is ops/probe.py:l4_shift(ylow, sp, mode); the
output is the whole NHWC plane of the last layer kept, as
stack_scale_upto(..., out="whole") gives it):
  base      layers 1-3 only, layer 3's plane
  l4        layer 4 as in production
  zshift    layer 4 with all its shifts forced to 0 (zero-shift mask 3;
            wrong by design)
  zdx       layer 4 with its column shifts forced to 0 (mask 1)
  preshift, stage, stagep, scratch
            Mosaic schedules of l4's function (a pre-shifted VPU copy of the
            column-shifted operand; layer 4 staged in VMEM before its store,
            whole or in part; layer 4 into a scratch with layer 3 written
            out). On Hopper a shift is a descriptor offset and the epilogue
            already stages its tile in shared memory (csrc/mma.cu), so the
            tool runs l4's kernels and says so; scratch returns layer 3's
            plane, as the JAX body writes x3.
A shift costs nothing here, and a zeroed tap reads p ^ 1, which no
descriptor reaches: zshift and zdx stage the window's pixel pairs swapped
(three more copies, one more). Their delta to l4 is the price of those
copies, not of a shift.

Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its delta (l4 to base, the others to l4), its bound and the chunk
plan of layer 4 that ran.

    python3 -m waifu2x_torch.tools.l4_shift_probe   # base l4 zshift zdx preshift scratch
    python3 -m waifu2x_torch.tools.l4_shift_probe base l4 zshift zdx preshift stage stagep scratch

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

MODES = list(probe.L4_MODES)
DEFAULT = ["base", "l4", "zshift", "zdx", "preshift", "scratch"]


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, DEFAULT, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, _ = setup(args, ap, MODES)
    print(f"l4_shift_probe: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}; a zeroed layer's delta is the price of its "
          f"swapped window copies, not of a shift", flush=True)
    times = {}
    for mode in args.modes:
        upto, zs4, keep = probe.L4_MODES[mode]
        ms = time_ms(lambda _: probe.l4_shift(ylow, sp, mode), dev,
                     args.iters, graph=True)
        bound, by = bound_ms(ylow, upto, "whole")
        line = f"{mode:>10}: {ms:9.3f} ms"
        ref = "base" if mode == "l4" else "l4"
        if mode != "base" and ref in times:
            line += f"  delta to {ref} {ms - times[ref]:+9.3f} ms"
        plan = (probe.variant_plans(zs4, layers=(4,)) if upto == 4
                else "no layer 4")
        note = ""
        if mode in probe.L4_SAME_AS_L4:
            note = ("  a Mosaic schedule of l4: ran l4's kernels"
                    + (", returned layer 3's plane" if keep == 3 else ""))
        print(f"{line}  bound {bound:.3f} ms by {by}  layer 4 mask {zs4}, "
              f"kc x stages: {plan}{note}", flush=True)
        times[mode] = ms
        if rows is not None:
            rows.append({"mode": mode, "ms": ms, "zs": zs4, "bound_ms": bound,
                         "bound_by": by, "plans": plan, "note": note.strip()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
