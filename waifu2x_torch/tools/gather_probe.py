"""How B7's gather (csrc/gather.cu:upto_gather_tiled, stack_scale_upto at
upto 0..5) depends on its grid and its walk.

csrc/gather.cu is built once a variant with its tuning macros set otherwise
(W2X_GT_BLOCKS and W2X_GT_ACT_BLOCKS: blocks an SM of the persistent grid
in the low-res modes and in GATHER_ACT; W2X_GT_UNROLL: vectors a lane
builds before it stores), and each build's w2x_upto_gather is timed in
turns with the others at scale512 (16 x 512^2, the shipped scale2.0x
weights, a plane drawn from --seed), in every mode and both storage types,
each output held bit for bit against the default build's.

    python3 -m waifu2x_torch.tools.gather_probe

Needs a CUDA card. --device cpu rehearses the inputs and the plain
version at --size, with no build and no timing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.ops import _build, stack
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_name, time_ms

MODELS = Path(__file__).resolve().parents[2] / "models"
VARIANTS = {"default": (), "act_blocks2": ("-DW2X_GT_ACT_BLOCKS=2",),
            "act_blocks8": ("-DW2X_GT_ACT_BLOCKS=8",),
            "blocks4": ("-DW2X_GT_BLOCKS=4",),
            "unroll2": ("-DW2X_GT_UNROLL=2",),
            "unroll8": ("-DW2X_GT_UNROLL=8",)}
# (label, upto, stack_scale_upto's output form)
CASES = (("ACT upto 5", 5, "cell"), ("ACT upto 1", 1, "cell"),
         ("TAPS", 0, "cell"), ("LANE0", 0, "lane0"), ("PAD", 0, "whole"))
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         *[ctypes.c_int] * 7, ctypes.c_void_p]


def build_variants(names) -> dict:
    """csrc/gather.cu built once a variant, all at once -> loaded
    libraries."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _build.BUILD_DIR / f"libgather-{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *VARIANTS[name], "-o",
             str(so), str(_build.CSRC_DIR / "gather.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for gather.cu {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.w2x_upto_gather.argtypes = _ARGS
        lib.w2x_upto_gather.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(dev, dtype, seed: int, size):
    """(ylow, sp): the plane and the shipped scale weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, s = (16, 512) if size is None else (1, size)
    ylow = torch.rand((n, s, s), device=dev, generator=gen).to(dtype)
    sp = stack.prep_params(load_model_json(MODELS / "scale2.0x_demo.json"),
                           dtype, dev)
    return ylow, sp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--size", type=int, default=None,
                    help="one square plane of this size (rehearsal)")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        ylow, sp = inputs(dev, torch.float32, args.seed, args.size or 12)
        for label, k, out in CASES:
            got = stack.stack_scale_upto(ylow, sp, k, out=out)
            print(f"{label}: {tuple(ylow.shape)} -> {tuple(got.shape)} "
                  f"(plain version); no card, nothing timed")
        return 0
    names = ["default"] + [v for v in args.variants if v != "default"]
    libs = build_variants(names)
    smi = card_name()
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"gather_probe on {smi}, variants {names}")
    for dtype in (torch.float32, torch.bfloat16):
        ylow, sp = inputs(dev, dtype, args.seed, args.size)
        n, hl, wl = ylow.shape
        for label, k, out in CASES:
            src = ylow if k == 0 else stack.stack_scale_upto(ylow, sp, k,
                                                             out="whole")
            mode = stack._GATHER_LOWRES[out] if k == 0 else 0
            pad = 8 if out == "whole" else 0
            y = torch.empty((n, hl + pad, wl + pad, 1 if pad else 4),
                            dtype=dtype, device=dev)
            hk, wk = 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k
            ck = stack.WIDTHS[k - 1][1] if k else 1

            def launch(lib):
                def run(_):
                    err = lib.w2x_upto_gather(
                        int(dtype == torch.bfloat16), src.data_ptr(),
                        y.data_ptr(), n, hl, wl, hk, wk, ck, mode, stream)
                    if err:
                        raise RuntimeError(f"w2x_upto_gather: error {err}")
                return run

            launch(libs["default"])(0)
            want = y.clone()
            runs = {name: launch(libs[name]) for name in names}
            for name, run in runs.items():
                y.zero_()
                run(0)
                if not torch.equal(y, want):
                    print(f"{label} {dtype}: {name} differs from default")
                    return 1
            order = list(runs) + list(runs)[::-1]
            ms = {name: [] for name in runs}
            for name in order:
                ms[name].append(time_ms(runs[name], dev, 5))
            print(json.dumps({"case": label, "dtype": str(dtype),
                              "card": smi,
                              "ms": {name: sum(t) / len(t)
                                     for name, t in ms.items()},
                              "turns": ms}))
            del src, y, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
