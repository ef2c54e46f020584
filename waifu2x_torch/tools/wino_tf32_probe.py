"""Where the time of B5's f32 Winograd layer 6 goes (csrc/wino.cu's
l6_wino_tf32, 3xTF32 on the tensor cores).

The kernel is timed in turns with two builds of the same source that
compile a part out:
  no_mma   -DW2X_WINO_NO_MMA: no products; the forming of V, its TF32
           split and the loads of the window and of U's halves;
  no_form  -DW2X_WINO_NO_FORM: constant fragments; the products and the
           loads.
Their outputs mean nothing; only their times do. Each is held to its
pieces: the whole kernel is first checked against the plain version
(stack._l6_wino_plain, within 3e-5). The planes are the real layer-5
outputs (stack.layer5_plane) of the ns1080 noise stack (4 x 1080 x 1920,
the shipped noise2 weights) and, with --scale512, of scale512's scale
stack (16 x 512 x 512, scale2.0x), from planes drawn from --seed.

    python3 -m waifu2x_torch.tools.wino_tf32_probe [--scale512]

Needs a CUDA card. --device cpu --size 12 rehearses: the plain version and
wino_layer's CPU path on a small plane, no build and no timing.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.ops import _build, stack
from waifu2x_torch.ops.convstack import no_tf32
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.timing import card_name, time_ms

MODELS = Path(__file__).resolve().parents[2] / "models"
VARIANTS = {"no_mma": "-DW2X_WINO_NO_MMA", "no_form": "-DW2X_WINO_NO_FORM"}
_ARGS = [ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 3,
         ctypes.c_void_p]


def build_variants() -> dict:
    """csrc/wino.cu built once a variant, all at once, into the build
    directory -> the loaded libraries by variant."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "wino.cu"
    procs = {}
    for name, flag in VARIANTS.items():
        so = _build.BUILD_DIR / f"libwino-{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, flag, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for wino.cu {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.w2x_l6_wino_tf32.argtypes = _ARGS
        lib.w2x_l6_wino_tf32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def plain(x5: torch.Tensor, sp) -> torch.Tensor:
    """_l6_wino_plain (V in f32, TF32 off) a frame at a time, NHWC."""
    with no_tf32():
        return torch.cat([stack._l6_wino_plain(
            x5[i:i + 1].permute(0, 3, 1, 2), sp, torch.float32
        ).permute(0, 2, 3, 1) for i in range(x5.shape[0])])


def planes(dev: torch.device, seed: int, scale512: bool, size=None):
    """(name, x5, StackParams) of each plane the probe times."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sp_n = stack.prep_params(load_model_json(MODELS / "noise2_demo.json"),
                             torch.float32, dev)
    shape = (4, 1080, 1920) if size is None else (1, size, size)
    out = [("ns1080" if size is None else f"{size}x{size}",
            stack.layer5_plane(torch.rand(shape, device=dev, generator=gen),
                               sp_n, full_res=True), sp_n)]
    if scale512:
        sp_s = stack.prep_params(load_model_json(
            MODELS / "scale2.0x_demo.json"), torch.float32, dev)
        out.append(("scale512", stack.layer5_plane(torch.rand(
            (16, 512, 512), device=dev, generator=gen), sp_s), sp_s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=27)
    ap.add_argument("--scale512", action="store_true")
    ap.add_argument("--size", type=int, default=None,
                    help="one square noise plane of this size (rehearsal)")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        for name, x5, sp in planes(dev, args.seed, False, args.size or 12):
            got = stack.wino_layer(x5, sp)
            err = (got - plain(x5, sp)).abs().max().item()
            print(f"{name}: x5 {tuple(x5.shape)}, wino_layer (CPU) against "
                  f"the plain version {err:.3e}; no card, nothing timed")
            if not err <= 3e-5:
                return 1
        return 0
    libs = build_variants()
    print(f"wino_tf32_probe on {card_name()}")
    for name, x5, sp in planes(dev, args.seed, args.scale512, args.size):
        n, h5, w5, _ = x5.shape
        err = (stack.wino_layer(x5, sp) - plain(x5, sp)).abs().max().item()
        if not err <= 3e-5:
            print(f"{name}: the kernel is {err} from its plain version")
            return 1
        y = torch.empty((n, h5 - 2, w5 - 2, 128), device=dev)

        def variant(lib):
            def run(_):
                e = lib.w2x_l6_wino_tf32(
                    0, x5.data_ptr(), sp.w6t[0].data_ptr(),
                    sp.w6t[1].data_ptr(), sp[5][1].data_ptr(), y.data_ptr(),
                    n, h5, w5, torch.cuda.current_stream(dev).cuda_stream)
                if e:
                    raise RuntimeError(f"l6_wino_tf32 variant: error {e}")
            return run

        runs = {"kernel": lambda _: stack.wino_layer(x5, sp),
                **{k: variant(lib) for k, lib in libs.items()}}
        turns = {k: [] for k in runs}
        for k in (*runs, *reversed(runs)):
            turns[k].append(time_ms(runs[k], dev, args.iters))
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        blocks = n * ((h5 - 2) // 2) * ((w5 - 2) // 2)
        peak_ms = 2 * 3 * blocks * 24 * 128 * 128 / 494.7e12 * 1e3
        print(f"{name}: x5 {tuple(x5.shape)} f32, max|kernel - plain| "
              f"{err:.3e}; " + "; ".join(
                  f"{k} {ms[k]:.3f} ms (turns "
                  + " / ".join(f"{v:.3f}" for v in turns[k]) + ")"
                  for k in runs)
              + f"; the kernel's 24 products a block as three TF32 "
              f"products at the 494.7 TFLOP/s peak: {peak_ms:.3f} ms")
        del x5, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
