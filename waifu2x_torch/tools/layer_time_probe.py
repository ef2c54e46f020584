"""Per-layer timing of the scale stack's CUDA kernels through the truncated
stack (the counterpart of the JAX package's tools/layer_time_probe.py).

Runs ops.stack.stack_scale_upto for upto = 0..6 and the whole stack
(stack_scale) on one batch of low-res planes in bf16 with random-init
weights, times each with CUDA events after a warm-up run, and prints the
cumulative time of every truncation with its delta to the one before
(the cost that layer adds in place) and its bound. Beside them it prints
the per-layer times that the whole stack's own `events=` argument records.
print_ladder and bound_ms serve the truncation probes too
(fused_strip_probe, k1_forensics, l14_probe). The port
launches one kernel per layer, so the two columns should agree; a fused
kernel would only have the first.

    python3 -m waifu2x_torch.tools.layer_time_probe            # 16 x 512^2
    python3 -m waifu2x_torch.tools.layer_time_probe --l6 i8 --size 256 5 6 full

Needs a CUDA card. --device cpu runs the plain versions on the host's
clock, to rehearse the script at a small --size; those are no device times.
"""

from __future__ import annotations

import argparse
import sys

import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.probe import PEAK_BF16_FLOPS, PEAK_BYTES
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line, time_ms

MODES = ["0", "1", "2", "3", "4", "5", "6", "full"]


def bound_ms(ylow: torch.Tensor, upto: int, out: str = "cell"):
    """(least ms, "operations" or "bytes") of stack_scale_upto(ylow, sp,
    upto, out=out) on the card, upto = 7 for the whole stack: layers 1..upto
    at the bf16 peak over every full-res pixel (layer 7's taps: 9 a pixel,
    or 4 a cell for "phase_taps"), against ylow, the weights of those layers
    and the output, each once, at the memory rate."""
    n, hl, wl = ylow.shape
    item, px = ylow.element_size(), 4 * n * hl * wl
    flops = sum(2 * 9 * ci * co * px for ci, co in stack.WIDTHS[:min(upto, 6)])
    if upto == 6:
        flops += 2 * 128 * (4 * n * hl * wl if out == "phase_taps" else 9 * px)
    elif upto == 7:
        flops += 2 * 9 * 128 * px
    weights = sum(9 * ci * co * item + 4 * co
                  for ci, co in stack.WIDTHS[:upto])
    if out == "whole":
        side = (lambda s: 2 * s + 14 - 2 * upto) if upto else (lambda s: s + 8)
        outb = n * side(hl) * side(wl) * (stack.WIDTHS[upto - 1][1] if upto
                                          else 1) * item
    else:
        outb = n * hl * wl * 4 * item
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (ylow.numel() * item + weights + outb) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def print_ladder(entries, dev: torch.device, iters: int,
                 graph: bool = False, rows: "list | None" = None) -> list:
    """Time each entry (label, fn, bound, note, in_ladder) with time_ms and
    print its ms, for a rung of the ladder its delta to the rung before,
    its bound ((ms, by) or None) and the note -> the times; each entry's
    numbers are appended to `rows` as a dict where given."""
    prev, times = None, []
    for label, fn, bound, note, in_ladder in entries:
        ms = time_ms(lambda _: fn(), dev, iters, graph)
        line = f"{label}: {ms:9.3f} ms"
        if in_ladder and prev is not None:
            line += f"  delta {ms - prev:+9.3f} ms"
        if bound is not None:
            line += f"  bound {bound[0]:.3f} ms by {bound[1]}"
        print(line + (f"  {note}" if note else ""), flush=True)
        if in_ladder:
            prev = ms
        times.append(ms)
        if rows is not None:
            rows.append({"mode": label.strip(), "ms": ms,
                         "bound_ms": bound and bound[0],
                         "bound_by": bound and bound[1], "note": note})
    return times


def _events_ms(run, iters: int) -> list:
    """Per-layer ms from the 8 events a whole-stack call records."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    ms = [0.0] * 7
    for _ in range(iters):
        run(events)
        torch.cuda.synchronize()
        for k in range(7):
            ms[k] += events[k].elapsed_time(events[k + 1]) / iters
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=MODES,
                    help="truncations to time: 0..6 and full (default: all)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512,
                    help="low-res plane height and width")
    ap.add_argument("--l6", choices=("direct", "i8", "wino"),
                    default="direct", help="layer 6's form")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = [m for m in args.modes if m not in MODES]
    if bad:
        ap.error(f"unknown modes {bad}; choose from {MODES}")

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    sp = stack.prep_params(init_params(args.seed), dtype, dev)
    gen = torch.Generator().manual_seed(args.seed)
    ylow = torch.rand((args.batch, args.size, args.size),
                      generator=gen).to(dev, dtype)
    kw = {"l6_i8": args.l6 == "i8", "l6_wino": args.l6 == "wino"}
    print(f"scale stack, {args.batch} x {args.size}^2 low-res {args.dtype}, "
          f"layer 6 {args.l6}; {card_line(dev)}", flush=True)

    layer_ms = None
    if dev.type == "cuda" and "full" in args.modes:
        stack.stack_scale(ylow, sp, **kw)          # warm-up
        layer_ms = _events_ms(
            lambda ev: stack.stack_scale(ylow, sp, events=ev, **kw),
            args.iters)
    entries = []
    for mode in args.modes:
        k = 7 if mode == "full" else int(mode)
        fn = ((lambda: stack.stack_scale(ylow, sp, **kw)) if k == 7 else
              (lambda k=k: stack.stack_scale_upto(ylow, sp, k, **kw)))
        note = (f"events= layer {k}: {layer_ms[k - 1]:9.3f} ms"
                if layer_ms is not None and k else "")
        entries.append((f"upto {mode:>4}", fn, bound_ms(ylow, k), note, True))
    print_ladder(entries, dev, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
