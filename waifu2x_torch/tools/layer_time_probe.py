"""Per-layer timing of the scale stack's CUDA kernels through the truncated
stack (the counterpart of the JAX package's tools/layer_time_probe.py).

Runs ops.stack.stack_scale_upto for upto = 0..6 and the whole stack
(stack_scale) on one batch of low-res planes in bf16 with random-init
weights, times each with CUDA events after a warm-up run, and prints the
cumulative time of every truncation with its delta to the one before:
the cost that layer adds in place. Beside them it prints the per-layer
times that the whole stack's own `events=` argument records. The port
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
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_line, time_ms

MODES = ["0", "1", "2", "3", "4", "5", "6", "full"]


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
    prev = None
    for mode in args.modes:
        if mode == "full":
            ms = time_ms(lambda _: stack.stack_scale(ylow, sp, **kw), dev,
                          args.iters)
        else:
            ms = time_ms(lambda _, k=int(mode): stack.stack_scale_upto(
                ylow, sp, k, **kw), dev, args.iters)
        line = f"upto {mode:>4}: {ms:9.3f} ms"
        if prev is not None:
            line += f"  delta {ms - prev:+9.3f} ms"
        if layer_ms is not None and mode != "0":
            k = 6 if mode == "full" else int(mode) - 1
            line += f"  events= layer {k + 1}: {layer_ms[k]:9.3f} ms"
        print(line, flush=True)
        prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
