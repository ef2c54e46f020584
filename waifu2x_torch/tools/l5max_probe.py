"""Where the time of B4's tile maxima in layer 5's epilogue goes (csrc/
mma.cu's conv3x3_bias_leaky_mma with AM, stack.layer5_maxima), in bf16.

The AM instance is timed in turns with the default layer 5 and with two
builds of csrc/mma.cu that compile one of its parts out (W2X_AM_PARTS):
  pixels   1: the pixel maxima in the epilogue, no windows' reduction;
  windows  2: the windows' reduction and its atomics over zeros.
Their maxima mean nothing; only their times do. The whole instance is
first held to tile_max_plain bit for bit. The plane
is layer 4's output shape at scale512 (16 x 1030^2 x 64, drawn from
--seed), the shipped scale2.0x weights, the default tile or --tile.

    python3 -m waifu2x_torch.tools.l5max_probe [--tile 64 128]

Needs a CUDA card. --device cpu --cells 8 12 --tile 4 4 rehearses the
plain version, no build and no timing.
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
VARIANTS = {"pixels": "-DW2X_AM_PARTS=1", "windows": "-DW2X_AM_PARTS=2"}
_ARGS = [ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 4,
         ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_void_p]


def build_variants() -> dict:
    """csrc/mma.cu built once a variant, all at once -> loaded libraries."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flag in VARIANTS.items():
        so = _build.BUILD_DIR / f"libmma-am-{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, flag, "-o", str(so),
             str(_build.CSRC_DIR / "mma.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for mma.cu {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.w2x_mma_layer_max.argtypes = _ARGS
        lib.w2x_mma_layer_max.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--cells", type=int, nargs=2, default=(512, 512))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tile", type=int, nargs=2, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    hl, wl = args.cells
    tile = tuple(args.tile) if args.tile else stack.default_tile(hl, wl)
    tr, tc = tile
    ny, nx = -(-hl // tr), -(-wl // tc)
    dtype = torch.bfloat16
    sp = stack.prep_params(load_model_json(MODELS / "scale2.0x_demo.json"),
                           dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x4 = torch.rand((args.batch, 2 * ny * tr + 6, 2 * nx * tc + 6, 64),
                    device=dev, generator=gen).to(dtype)
    x5, m = stack.layer5_maxima(x4, sp, tile)
    if not torch.equal(m, stack.tile_max_plain(x5, tile)):
        print("layer5_maxima's maxima differ from tile_max_plain's")
        return 1
    if dev.type != "cuda":
        print(f"x4 {tuple(x4.shape)} -> x5 {tuple(x5.shape)}, m "
              f"{tuple(m.shape)} (plain version); no card, nothing timed")
        return 0
    libs = build_variants()
    n, hin, win, _ = x4.shape
    smem = stack.mma_plan(64, 128, persistent=False).smem_bytes
    stream = torch.cuda.current_stream(dev).cuda_stream

    def variant(lib):
        def run(_):
            m.zero_()
            err = lib.w2x_mma_layer_max(
                1, x4.data_ptr(), sp.wm[3].data_ptr(), sp[4][1].data_ptr(),
                x5.data_ptr(), n, hin, win, smem, m.data_ptr(), *tile, ny,
                nx, stream)
            if err:
                raise RuntimeError(f"w2x_mma_layer_max: error {err}")
        return run

    runs = {"layer5": lambda _: stack.mma_layer(x4, sp, 5),
            "maxima": lambda _: stack.layer5_maxima(x4, sp, tile),
            **{name: variant(lib) for name, lib in libs.items()}}
    order = list(runs) + list(runs)[::-1]
    ms = {name: [] for name in runs}
    for name in order:
        ms[name].append(time_ms(runs[name], dev, 5))
    print(json.dumps({"card": card_name(), "x4": list(x4.shape),
                      "tile": list(tile),
                      "ms": {k: sum(v) / len(v) for k, v in ms.items()},
                      "turns": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
