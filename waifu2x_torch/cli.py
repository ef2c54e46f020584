"""Command-line interface of the port — the reference's flag set on the CUDA
card (the counterpart of the JAX package's cli.py).

Replaces the reference's TCLAP CLI (main.cpp:26-71, C1) with argparse.
Every reference flag keeps its name, constraints and default, and so does
every extension flag of the JAX package's CLI, except --device: here it
chooses between the CUDA card (the default) and the CPU.

    waifu2x-torch -i in.png [-o out.png] [-m noise|scale|noise_scale]
                  [--noise_level 1|2] [--scale_ratio 2.0] [--model_dir DIR]
                  [-j 4] [--mesh auto|off|DPxSP|DPxDYxSP]
                  [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from waifu2x_torch import io as w2x_io
from waifu2x_torch.config import Config
from waifu2x_torch.utils import trace
from waifu2x_torch.utils.logging import get_logger

log = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waifu2x-torch",
        description="waifu2x on an NVIDIA card (PyTorch + CUDA kernels)",
    )
    # TCLAP auto-provides --version; the reference registers "1.0.0"
    # (main.cpp:26)
    p.add_argument("--version", action="version", version="1.0.0")
    # --- reference flags, identical semantics (main.cpp:26-61) ---
    p.add_argument("-i", "--input_file", required=True, nargs="+",
                   action="extend",
                   help="path to input image file(s); multiple files are "
                        "decoded by the native thread pool (-j) and share "
                        "one loaded model (outputs auto-named). Both "
                        "'-i a b c' and repeated '-i a -i b' accumulate "
                        "(argparse's default would silently keep only the "
                        "last -i)")
    p.add_argument("-o", "--output_file", default="(auto)",
                   help="path to output image file")
    p.add_argument("-m", "--mode", default="noise_scale",
                   choices=["noise", "scale", "noise_scale"],
                   help="image processing mode")
    p.add_argument("--noise_level", type=int, default=1, choices=[1, 2],
                   help="noise reduction level")
    p.add_argument("--scale_ratio", type=float, default=2.0,
                   help="custom scale ratio")
    p.add_argument("--model_dir", default=None,
                   help="path to custom model directory (don't append last /)")
    p.add_argument("-j", "--jobs", type=int, default=4,
                   help="number of host worker threads")
    # --- extensions (the JAX package's flag set) ---
    p.add_argument("--block_size", type=int, default=512,
                   help="block-splitting threshold size (reference: 512)")
    p.add_argument("--tile_size", type=int, default=512,
                   help="tile size of the non-kernel path's block tiler")
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="f32 conv precision (the port runs f32 at full "
                        "precision, TF32 off)")
    p.add_argument("--compute_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="auto = float32 non-kernel path / bfloat16 CUDA "
                        "kernels (f32 accumulation); explicit values are "
                        "honored on both paths")
    p.add_argument("--pallas", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="the hand-written CUDA conv-stack kernels: 'auto' "
                        "(default) enables them on the card for the "
                        "flagship 7-layer model; 'on' forces them (their "
                        "plain PyTorch versions on the CPU, slow); 'off' "
                        "always uses the F.conv2d path")
    p.add_argument("--alpha", default="ignore",
                   choices=["ignore", "bicubic", "flatten"],
                   help="alpha channel: drop it (reference behavior), "
                        "bicubic-resample it alongside, or flatten onto a "
                        "white background before processing (the original "
                        "Lua loader's behavior, image_loader.lua:23-33)")
    p.add_argument("--mesh", default="auto",
                   help="multi-device mesh: 'auto' (default: every card on "
                        "a host with two or more, else one), 'off', or "
                        "'DPxSP' / 'DPxDYxSP' to pin a shape (frames x rows "
                        "x columns). With --device cpu a pinned shape runs "
                        "on that many CPU positions")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to convert: 'cuda' (default) on the card, "
                        "'cpu' on the host; there is no fallback from one "
                        "to the other")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        mode=args.mode,
        noise_level=args.noise_level,
        scale_ratio=args.scale_ratio,
        model_dir=(args.model_dir if args.model_dir is not None
                   else w2x_io.default_model_dir()),
        jobs=args.jobs,
        block_size=args.block_size,
        tile_size=args.tile_size,
        precision=args.precision,
        compute_dtype=args.compute_dtype,
        use_pallas={"auto": "auto", "on": True, "off": False}[args.pallas],
        mesh=args.mesh,
        alpha=args.alpha,
    )


@contextlib.contextmanager
def _profiled(trace_dir: "str | None", device: torch.device, spans: dict):
    """A torch.profiler trace of the block, written to trace_dir as a
    Chrome trace (CPU activity, and CUDA activity on the card), the
    program's spans in it; `spans` gets their sums by name
    (utils/trace.summary)."""
    if trace_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace.reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    spans.update(trace.summary())
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "waifu2x_torch.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("profile trace written to %s", path)


def _write(path: str, out: np.ndarray, secs: dict) -> float:
    t = time.perf_counter()
    w2x_io.imwrite_bgr(path, out)
    secs["encode"] += time.perf_counter() - t
    log.info("wrote %s", path)
    return out.shape[0] * out.shape[1] / 1e6


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is available; pass --device cpu to "
                  "convert on the CPU")
        return 1
    if args.device == "cpu" and args.pallas == "on":
        log.warning("--pallas on the CPU runs the kernels' plain PyTorch "
                    "versions (slow; intended for debugging)")

    from waifu2x_torch.parallel import mesh as w2x_mesh
    shape = cfg.mesh_shape()
    cpu_devices = w2x_mesh.CPU_DEVICES
    if args.device == "cpu" and isinstance(shape, tuple):
        # an explicit mesh on the CPU takes that many CPU positions, as the
        # JAX package's CLI asks XLA for that many virtual host devices
        w2x_mesh.CPU_DEVICES = max(cpu_devices, math.prod(shape))
    try:
        return _run(args, cfg)
    finally:
        w2x_mesh.CPU_DEVICES = cpu_devices


def _run(args: argparse.Namespace, cfg: Config) -> int:
    from waifu2x_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()   # before Converter.from_config loads kernels

    from waifu2x_torch.pipeline import SMALL_IMG_PX, Converter, scale_plan
    from waifu2x_torch.stream import StreamConverter, resolve_stream_mesh

    if args.model_dir is None:
        # default model dir: materialise missing model files from the
        # shipped *_demo.json weights, identity placeholders otherwise
        from waifu2x_torch.models.zoo import ensure_default_models
        made = ensure_default_models(cfg.model_dir)
        if made:
            log.warning("materialized default models: %s", ", ".join(made))

    inputs = args.input_file
    if len(inputs) > 1 and args.output_file != "(auto)":
        log.error("-o is only valid with a single input file "
                  "(multiple inputs auto-name their outputs)")
        return 1

    t0 = time.perf_counter()
    try:
        converter = Converter.from_config(cfg, device=args.device)
    except FileNotFoundError as e:
        log.error("%s", e)
        return 1

    secs = {"decode": 0.0, "convert": 0.0, "encode": 0.0}
    t = time.perf_counter()
    try:
        imgs = (w2x_io.imread_batch_bgr(inputs, jobs=cfg.jobs)
                if len(inputs) > 1 else [w2x_io.imread_bgr(inputs[0])])
    except (OSError, ValueError) as e:   # missing, unreadable, unsupported
        log.error("%s", e)
        return 1
    secs["decode"] += time.perf_counter() - t

    if cfg.mode in ("noise", "noise_scale"):
        log.info("noise reduction (level %d)", cfg.noise_level)
    if cfg.mode in ("scale", "noise_scale"):
        log.info("start scaling (ratio %.6f)", cfg.scale_ratio)

    # Several inputs with stream-compatible settings ride the dispatch-ahead
    # StreamConverter (per-shape batching, the card kept busy across files)
    # instead of the per-image loop. Conditions: the kernel stacks exist
    # (a card, the flagship model), the scale part is one 2x iteration with
    # no shrink (the stream's contract), no alpha handling, and every image
    # big enough for the kernel path's fidelity gate (SMALL_IMG_PX) unless
    # --pallas on forces it.
    stream_ok = (
        len(imgs) > 1 and cfg.alpha == "ignore"
        and (cfg.mode == "noise" or scale_plan(cfg.scale_ratio) == (1, 0.0))
        and (cfg.mode == "noise" or converter.fast_scale is not None)
        and (cfg.mode == "scale" or converter.fast_noise is not None)
        and (cfg.use_pallas is True
             or all(im.shape[0] * im.shape[1] >= SMALL_IMG_PX
                    for im in imgs)))

    total_mp = 0.0
    spans = {}
    with _profiled(args.profile, converter.device, spans):
        if stream_ok:
            sc = StreamConverter(
                fast=converter.fast_scale,
                fast_noise=converter.fast_noise, mode=cfg.mode,
                device=converter.device,
                mesh=resolve_stream_mesh(cfg.mesh_shape(),
                                         converter.device))
            outs = iter(sc.process_frames(imgs))
            for path in inputs:
                t = time.perf_counter()
                out = next(outs)
                secs["convert"] += time.perf_counter() - t
                total_mp += _write(w2x_io.auto_output_name(
                    path, cfg.mode, cfg.noise_level, cfg.scale_ratio),
                    out, secs)
        else:
            for path, img in zip(inputs, imgs):
                t = time.perf_counter()
                alpha = None
                if cfg.alpha == "bicubic":
                    bgra = w2x_io.imread_bgra(path)
                    if bgra is not None:
                        alpha = bgra[:, :, 3]
                elif cfg.alpha == "flatten":
                    bgra = w2x_io.imread_bgra(path)
                    if bgra is not None:
                        img = w2x_io.flatten_white(bgra)
                secs["decode"] += time.perf_counter() - t

                t = time.perf_counter()
                out = converter.process_bgr_u8(img)
                if alpha is not None:
                    a = converter.process_alpha(alpha)
                    out = np.concatenate([out, a[:, :, None]], axis=2)
                secs["convert"] += time.perf_counter() - t

                out_name = args.output_file
                if out_name == "(auto)" or len(inputs) > 1:
                    out_name = w2x_io.auto_output_name(
                        path, cfg.mode, cfg.noise_level, cfg.scale_ratio)
                total_mp += _write(out_name, out, secs)

    dt = time.perf_counter() - t0
    run = dict(secs, files=len(inputs), mp=total_mp, seconds=dt,
               route="stream" if stream_ok else "per_image")
    if args.profile is not None:
        run["spans"] = spans
    log.info("%d file(s), %.2f MP in %.3fs (%.2f MP/s incl. kernel build; "
             "decode %.3fs, convert %.3fs, encode %.3fs)", len(inputs),
             total_mp, dt, total_mp / dt, secs["decode"], secs["convert"],
             secs["encode"], extra={"w2x_run": run})
    log.info("process successfully done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
