"""The benchmark's one command, run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It runs the cell named in BENCHMARK.json (benchmark/workloads/<cell>.json)
on the CUDA card and prints, as the last line of standard output, one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device, with
--trace 1 a breakdown, and last the numbers compared with their limits,
which also end standard error. With no card, too few cards, no program
beside it or JAX in the process, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few host threads: the host's share stays steady
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    wl = harness.workload(args.workload)
    harness.set_env(wl)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    import waifu2x_torch
    if ROOT not in Path(waifu2x_torch.__file__).resolve().parents:
        log(f"waifu2x_torch loaded from {waifu2x_torch.__file__}, "
            f"not from this checkout")
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(wl, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"the process loaded {', '.join(found)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
