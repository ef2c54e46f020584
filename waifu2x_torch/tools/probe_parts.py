"""Where the time of probe_fetch_reduce, probe_l1_mm and probe_fetch_map's
ring form goes (csrc/probe.cu: stage_time's cin1, cin4, cin9 and cin9mm,
grid_floor_probe's 4-fetch; dma_probe's lane16_x4, lane128 and lane128_x4,
dma_probe2's in16+o128, in128+o128 and raw+o128, l14_probe's xonly).

Each kernel is timed in turns with builds of the same source that compile a
part out:
  probe_l1_mm (cin9mm)
    no_mma   -DW2X_L1MM_NO_MMA: no products; the ring, the forming of A from
             the staged rows and the output;
    no_form  -DW2X_L1MM_NO_FORM: constant A fragments; the ring, the
             products and the output;
    no_out   -DW2X_L1MM_NO_OUT: no staging and no stores; the ring, the
             forming and the products;
    ring     all three: the consumers only wait for each row and hand it
             back;
  probe_fetch_reduce (cin1, cin4, cin9, 4-fetch)
    no_out   -DW2X_RED_NO_OUT: no output stores; the ring, the corner
             maxima or the lane-0 sums and the stash;
    ring     -DW2X_RED_RING: the consumers only wait for each slot and hand
             it back;
  probe_fetch_map, the ring form (the seven map variants)
    no_out   -DW2X_MAP_NO_OUT: no output stores; the ring and the forming
             of each output vector from the staged lanes;
    ring     -DW2X_MAP_RING: the consumers only wait for each slot and hand
             it back;
    out_only -DW2X_MAP_OUT_ONLY: nothing is copied; the walk and the output
             stores (of whatever the ring holds) alone.
Their outputs mean nothing; only their times do. Each kernel is first held
to its plain version bit for bit on make_inputs' inputs (k / 256 for the
sums), at the tools' grid of (64, 128) cells ((16, 8, 4) by default; the
map variants' tools run (4, 8, 4): --batch 4).

    python3 -m waifu2x_torch.tools.probe_parts [variant ...]
    python3 -m waifu2x_torch.tools.probe_parts --batch 4 lane16_x4 raw+o128

Needs a CUDA card. --device cpu --batch 1 --size 32 --tile 16 32 rehearses:
the wrappers' CPU paths against the plain versions, no build and no timing.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from waifu2x_torch.ops import _build, probe
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_name, time_ms

PARTS = {
    "l1_mm": {
        "no_mma": ("-DW2X_L1MM_NO_MMA",),
        "no_form": ("-DW2X_L1MM_NO_FORM",),
        "no_out": ("-DW2X_L1MM_NO_OUT",),
        "ring": ("-DW2X_L1MM_NO_MMA", "-DW2X_L1MM_NO_FORM",
                 "-DW2X_L1MM_NO_OUT"),
    },
    "fetch_reduce": {
        "no_out": ("-DW2X_RED_NO_OUT",),
        "ring": ("-DW2X_RED_RING",),
    },
    "fetch_map": {
        "no_out": ("-DW2X_MAP_NO_OUT",),
        "ring": ("-DW2X_MAP_RING",),
        "out_only": ("-DW2X_MAP_OUT_ONLY",),
    },
}
NAMES = ("cin1", "cin4", "cin9", "4-fetch", "cin9mm")
# the map variants on probe_fetch_map's ring form (csrc/probe.cu:
# w2x_probe_fetch_map routes them there)
MAP_NAMES = ("lane16_x4", "lane128", "lane128_x4", "in16+o128", "in128+o128",
             "raw+o128", "xonly")


def build_parts(kernels) -> dict:
    """csrc/probe.cu built once a part of each kernel, all at once, into
    the build directory -> {(kernel, part): the C entry}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "probe.cu"
    procs = {}
    for kernel in kernels:
        for part, flags in PARTS[kernel].items():
            so = _build.BUILD_DIR / f"libprobe-{kernel}-{part}.so"
            procs[kernel, part] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(so), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    entries = {}
    for (kernel, part), (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for probe.cu {part}:\n{out}")
        fn = getattr(ctypes.CDLL(str(so)), f"w2x_probe_{kernel}")
        fn.argtypes = probe._ARGTYPES[f"w2x_probe_{kernel}"]
        fn.restype = ctypes.c_int
        entries[kernel, part] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    probe.add_args(ap, batch=16)
    ap.add_argument("names", nargs="*", metavar="variant",
                    help=f"any of {', '.join(NAMES + MAP_NAMES)} "
                         f"(default: {', '.join(NAMES)})")
    args = ap.parse_args(argv)
    if not set(args.names) <= set(NAMES + MAP_NAMES):
        ap.error(f"variants are {', '.join(NAMES + MAP_NAMES)}")
    dev = resolve_device(args.device)
    g = probe.grid_from_args(args, ap)
    variants = [probe.VARIANTS[n] for n in args.names or NAMES]
    if dev.type != "cuda":
        ok = True
        for v in variants:
            a = probe.make_inputs(v, g, args.seed, dev)
            eq = probe.compare(probe.run(v, g, a), probe.plain(v, g, a))[2]
            print(f"{v.name}: grid {(g.batch, g.ny, g.nx)} of "
                  f"{(g.tr, g.tc)} cells, the CPU path "
                  f"{'equals' if eq else 'DIFFERS from'} the plain version; "
                  f"no card, nothing timed")
            ok = ok and eq
        return 0 if ok else 1
    entries = build_parts(sorted({v.kernel for v in variants}))
    print(f"probe_parts on {card_name()}: grid {(g.batch, g.ny, g.nx)} of "
          f"{(g.tr, g.tc)} cells", flush=True)
    for v in variants:
        sets = [probe.make_inputs(v, g, args.seed + k, dev) for k in range(3)]
        got = probe.run(v, g, sets[0], device=dev)
        if not probe.compare(got, probe.plain(v, g, sets[0], dev))[2]:
            print(f"{v.name}: the kernel differs from its plain version")
            return 1
        launches = [probe.prepare(v, g, s, device=dev)[1] for s in sets]

        def part(fn):
            keep, cargs = [], []   # outputs and packed weights stay alive
            for s in sets:
                keep.append(torch.empty_like(got))
                cargs.append(probe._c_args(v, g, s, keep[-1], keep=keep))

            def run(k, _keep=keep):
                # on the stream current at the call, so that a graph
                # captures it
                e = fn(*cargs[k % 3],
                       torch.cuda.current_stream(dev).cuda_stream)
                if e:
                    raise RuntimeError(f"{v.name} part: error {e}")
            return run

        runs = {"kernel": lambda k: launches[k % 3](),
                **{p: part(fn) for (kern, p), fn in entries.items()
                   if kern == v.kernel}}
        turns = {k: [] for k in runs}
        for k in (*runs, *reversed(runs)):
            turns[k].append(time_ms(runs[k], dev, args.iters, graph=True))
        ms = {k: sum(t) / len(t) for k, t in turns.items()}
        bound = probe.distinct_bytes(v, g) / probe.PEAK_BYTES * 1e3
        extra = ""
        if v.kernel == "l1_mm":
            mma_ms = (2 * 16 * 128 * g.cells * g.tr * g.tc
                      / probe.PEAK_BF16_FLOPS * 1e3)
            extra = (f"; the padded K = 16 products at 989 TFLOP/s "
                     f"{mma_ms:.4f} ms")
        print(f"{v.name}: " + "; ".join(
            f"{k} {ms[k]:.4f} ms (turns "
            + " / ".join(f"{t:.4f}" for t in turns[k]) + ")" for k in runs)
            + f"; bound {bound:.4f} ms by bytes{extra}", flush=True)
        del sets, launches, runs, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
