"""The stack with two accumulators per layer (the counterpart of the JAX
package's tools/accpp_probe.py).

B = 4 low-res planes of 512^2 in bf16, random-init weights at full width.
Modes, by the JAX names:
  prod  stack_scale, layers 2-6 on the tensor cores (csrc/mma.cu), one
        register accumulator of all CO outputs per warpgroup
  pp    ops/probe.py:stack_scale_pp, each of layers 2-6 with its outputs in
        two accumulators, each half its own wgmma group: after the last
        chunk the first half's epilogue runs while the second half's
        products finish
The JAX tool breaks a write-after-read chain through one shared VMEM
accumulator. On this card the sums live in registers; the matching hazard
is the wgmma queue drained before each epilogue. pp keeps every output's sum
order, so it equals prod bit for bit: the tool prints max |pp - prod| and
exits non-zero where it is not 0. It also prints whether ptxas serialized
the build's wgmma instructions (a serialized build has no overlap).

Each mode's time (CUDA events around back-to-back calls, captured in a CUDA
graph), its bound and the chunk plan of layers 2-6 that ran.

    python3 -m waifu2x_torch.tools.accpp_probe        # prod pp prod, as JAX

Needs a CUDA card. --device cpu runs the plain versions on the host's clock
(prod as the plain version of the tensor-core path,
stack_scale_plain(mma=True)), to rehearse at a small --size (--batch 1
--size 32 --tile 16 32 --iters 1).
"""

from __future__ import annotations

import argparse
import sys

from waifu2x_torch.ops import probe, stack
from waifu2x_torch.tools.fused_strip_probe import add_args, setup
from waifu2x_torch.tools.layer_time_probe import bound_ms
from waifu2x_torch.utils.timing import card_line, time_ms

MODES = ["prod", "pp"]
DEFAULT = ["prod", "pp", "prod"]


def serialization_note(dev) -> str:
    """What ptxas said about serializing wgmma in csrc/mma.cu's build."""
    if dev.type != "cuda":
        return "no build on the CPU"
    lines = probe.ptxas_serialized()
    if lines is None:
        return "ptxas output not seen (the library was built earlier)"
    if not lines:
        return "ptxas serialized no wgmma in csrc/mma.cu"
    return "ptxas: " + " | ".join(lines)


def main(argv=None, rows: "list | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(ap, MODES, DEFAULT, batch=4)
    args = ap.parse_args(argv)
    dev, sp, ylow, _ = setup(args, ap, MODES)
    print(f"accpp_probe: {args.batch} x {args.size}^2 low-res bf16; "
          f"{card_line(dev)}", flush=True)
    prod = (stack.stack_scale if dev.type == "cuda" else
            lambda y, s: stack.stack_scale_plain(y, s, mma=True))
    fns = {"prod": prod, "pp": probe.stack_scale_pp}
    bound, by = bound_ms(ylow, 7)
    ref, ok = None, True
    for mode in args.modes:
        fn = fns[mode]
        out = fn(ylow, sp)
        ms = time_ms(lambda _: fn(ylow, sp), dev, args.iters, graph=True)
        plans = probe.variant_plans(pp=mode == "pp")
        print(f"{mode:>10}: {ms:9.3f} ms  bound {bound:.3f} ms by {by}  "
              f"layers 2-6 kc x stages: {plans}", flush=True)
        row = {"mode": mode, "ms": ms, "bound_ms": bound, "bound_by": by,
               "plans": plans}
        if mode == "prod":
            ref = out
        elif ref is not None:
            err = (out.float() - ref.float()).abs().max().item()
            print(f"max |pp - prod| = {err}", flush=True)
            row["max_abs_err"] = err
            ok = ok and err == 0
        if rows is not None:
            rows.append(row)
    if "pp" in args.modes:
        print(serialization_note(dev), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
