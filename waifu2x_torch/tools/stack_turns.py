"""Time the scale512 stack calls of whichever waifu2x_torch is on the path,
and fingerprint their outputs, so that two trees can be compared in turns
in one session on one card.

Times stack_scale (B1) and stack_scale(l6_i8=True) (B4) in bf16 on a
16 x 512^2 plane drawn from --seed with the shipped scale2.0x weights (CUDA
events, --reps calls after a warm-up), and prints one JSON line with each
time and the SHA-256 of each output's bytes. Run it by path with the tree
to time first on PYTHONPATH:

    PYTHONPATH=/path/to/tree python3 waifu2x_torch/tools/stack_turns.py

for tree A, B, B, A; equal fingerprints mean bit-equal outputs. It reads
nothing but the tree's own package and models/. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name, time_ms

    if not torch.cuda.is_available():
        print("stack_turns needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pkg = Path(stack.__file__).resolve().parents[2]
    sp = stack.prep_params(load_model_json(
        pkg / "models" / "scale2.0x_demo.json"), torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ylow = torch.rand((16, 512, 512), device=dev, generator=gen).to(
        torch.bfloat16)
    out = {"tree": str(pkg), "card": card_name()}
    for name, kw in (("b1", {}), ("b4", {"l6_i8": True})):
        y = stack.stack_scale(ylow, sp, **kw)
        torch.cuda.synchronize()
        out[name + "_sha256"] = hashlib.sha256(
            y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        out[name + "_ms"] = time_ms(
            lambda _, kw=kw: stack.stack_scale(ylow, sp, **kw), dev,
            args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
