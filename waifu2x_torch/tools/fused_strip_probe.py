"""Per-layer strip of the stack at the truncation probe's grid (the
counterpart of the JAX package's tools/fused_strip_probe.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width
(1 -> 32 -> 32 -> 64 -> 64 -> 128 -> 128 -> 1). Modes, by the JAX names:
  0       the input stage alone: the low-res tap (0, 0) of each cell's
          window in all 4 lanes (stack_scale_upto, upto 0, out="lane0")
  1 .. 5  the stack stopped after layer k, 4 values of it per cell
          (stack_scale_upto, upto k)
  6       after layer 6, the unfolded layer-7 partials of each cell's pixel
          (0, 0), taps 0-3 (out="phase_taps")
  7       the whole stack (stack_scale)
  107, dimsem
          the whole stack under two Mosaic schedules (PAIR_DIRECT,
          dimension_semantics) that have no Hopper counterpart: the same
          function, so the tool runs stack_scale and says so
  oneblk  one (64, 128, 16) block of the layer-1 im2col array fetched a
          cell, its lane 0 written to 4 lanes (ops/probe.py, probe_fetch_map)
Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its delta to the mode before (0-7) and its bound.

    python3 -m waifu2x_torch.tools.fused_strip_probe        # 0..7 dimsem
    python3 -m waifu2x_torch.tools.fused_strip_probe 0 1 2 3 4 5 6 7 107 dimsem oneblk

Needs a CUDA card. --device cpu runs the plain versions on the host's clock,
to rehearse at a small --size (--batch 1 --size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops import probe, stack
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.tools.layer_time_probe import bound_ms, print_ladder
from waifu2x_torch.utils.timing import card_line

MODES = ["0", "1", "2", "3", "4", "5", "6", "7", "107", "dimsem", "oneblk"]
DEFAULT = ["0", "1", "2", "3", "4", "5", "6", "7", "dimsem"]
# what runs for each JAX mode: (label, upto or 7 for the whole stack, out)
RUNS = {"0": ("upto0", 0, "lane0"), "6": ("upto6", 6, "phase_taps"),
        "7": ("upto7", 7, None), "107": ("upto107", 7, None),
        "dimsem": ("full+dimsem", 7, None),
        **{str(k): (f"upto{k}", k, "cell") for k in range(1, 6)}}
SAME_AS_7 = ("107", "dimsem")


def add_args(ap, modes, default, batch: int) -> None:
    """The truncation tools' arguments."""
    ap.add_argument("modes", nargs="*", default=default,
                    help=f"modes to run, from {modes}")
    probe.add_args(ap, batch=batch)
    ap.set_defaults(iters=20)


def setup(args, ap, modes):
    """-> (device, weights, ylow, probe grid) from the parsed arguments."""
    bad = [m for m in args.modes if m not in modes]
    if bad:
        ap.error(f"unknown modes {bad}; choose from {modes}")
    dev = resolve_device(args.device)
    g = probe.grid_from_args(args, ap)
    sp = stack.prep_params(init_params(args.seed), torch.bfloat16, dev)
    gen = torch.Generator().manual_seed(args.seed)
    ylow = torch.rand((args.batch, args.size, args.size),
                      generator=gen).to(dev, torch.bfloat16)
    return dev, sp, ylow, g


def stack_entry(label: str, ylow, sp, upto: int, out, note: str = "",
                in_ladder: bool = True) -> tuple:
    """A print_ladder entry for stack_scale_upto(ylow, sp, upto, out=out),
    or stack_scale at upto 7."""
    fn = ((lambda: stack.stack_scale(ylow, sp)) if upto == 7 else
          (lambda: stack.stack_scale_upto(ylow, sp, upto, out=out)))
    return (f"{label:>12}", fn, bound_ms(ylow, upto, out or "cell"), note,
            in_ladder)


def run_probe_variant(name: str, g, dev, iters: int, seed: int,
                      rows) -> bool:
    """measure() and print a probe variant -> held its bar."""
    r = probe.measure(probe.VARIANTS[name], g, dev, iters, seed)
    print(probe.format_row(r), flush=True)
    if rows is not None:
        rows.append({"mode": name, "ms": r["ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "probe": r})
    return r["ok"]


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, DEFAULT, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, g = setup(args, ap, MODES)
    print(f"fused_strip_probe: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}", flush=True)
    entries = []
    for mode in args.modes:
        if mode == "oneblk":
            continue
        label, upto, out = RUNS[mode]
        note = ("a Mosaic schedule of the whole stack: ran stack_scale, "
                "mode 7's kernels" if mode in SAME_AS_7 else "")
        entries.append(stack_entry(label, ylow, sp, upto, out, note,
                                   mode not in SAME_AS_7))
    print_ladder(entries, dev, args.iters, graph=True, rows=rows)
    ok = True
    if "oneblk" in args.modes:
        ok = run_probe_variant("oneblk", g, dev, args.iters, args.seed, rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
