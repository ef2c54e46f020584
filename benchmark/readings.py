"""The readings the limits of `correct` are set from, at a cell's own size
and load, many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults seams --fault-seeds 7,8,9] \
        [--out FILE]

For each of --seeds the program runs one pass of the cell's traffic (every
batch once, `depth` in flight) and its checked batches are compared with
the reference, as a run compares them; for each of --control-seeds the
control (the reference one precision lower, harness.control_precisions) is
compared in the program's place. --faults runs the program on each of
--fault-seeds with a fault planted: `seams` drops the halo rows of every
band (waifu2x_torch.pipeline._bands with halo 0). Prints one JSON line a
reading (and appends it to --out) with the numbers and the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    wl = harness.workload(args.workload)
    harness.set_env(wl)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = harness.config(wl["config"])
    prog = harness.program(cfg, dev)
    card = harness.card_line()
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, True))

    def emit(kind: str, seed: int, nums, failed: int, t_ref: float):
        line = {"cell": wl["name"], "kind": kind, "seed": seed,
                "values": nums.values, "pass": nums.ok(), "failed": failed,
                "reference_s": t_ref, "card": card}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    def program(kind: str, seed: int):
        traffic = harness.Traffic(wl, seed, dev, gen)
        window = harness.run_window(prog, traffic, 0.0, int(wl["depth"]))
        got = harness.program_outputs(prog, window, dev)
        t = time.perf_counter()
        nums, failed = harness.check(cfg, wl, traffic, got, dev)
        torch.cuda.synchronize()
        emit(kind, seed, nums, failed, time.perf_counter() - t)

    for seed in args.seeds:
        program("program", seed)
    for seed in args.control_seeds:
        traffic = harness.Traffic(wl, seed, dev, gen)
        got = harness.control_outputs(cfg, traffic, dev)
        nums, failed = harness.check(cfg, wl, traffic, got, dev)
        emit("control", seed, nums, failed, 0.0)
    for fault in filter(None, args.faults.split(",")):
        if fault != "seams":
            raise ValueError(f"unknown fault {fault!r}")
        from waifu2x_torch import pipeline
        bands = pipeline._bands
        pipeline._bands = (lambda h, rows, halo=0, align=1:
                           bands(h, rows, 0, align))
        try:
            for seed in args.fault_seeds:
                program("fault:seams", seed)
        finally:
            pipeline._bands = bands
    return 0


if __name__ == "__main__":
    sys.exit(main())
