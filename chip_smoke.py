"""GPU smoke run of the waifu2x_torch port: builds the CUDA kernel, holds it
against its plain PyTorch version, drives the 2x scale main path at full
model width and prints its numbers.

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Phases (any failure raises and exits non-zero):
  1. build csrc/stack.cu with nvcc for sm_90a (ops/_build.py);
  2. f32 kernel vs plain version at small and odd shapes: max |diff| <= 3e-5;
  3. the kernel vs its plain version at the main path's shape
     (16 x 512^2 low-res): f32 max |diff| <= 3e-5; bf16 max |diff| against
     the bf16 plain version <= 2^-4 (rounding ties flip a bf16 unit at
     some layer and propagate), and >= 50 dB PSNR (peak 1) against the
     f32 plain version;
  4. the main path with the shipped scale2.0x weights on 16 seeded
     512 x 512 BGR u8 frames: _to_yuv -> scale2x_batch_u8_fused ->
     d2s_host_cmajor, with the launch counter read around it; frames 0-1
     >= 50 dB against the port's f32 non-kernel path; then
     Converter.process_bgr_u8 on a 720 x 1280 image against the f32
     non-kernel Converter: x2 (bf16 kernel) >= 50 dB, x4 (two chained bf16
     stacks) >= 45 dB, x4 with f32 kernels >= 50 dB; then timings with
     CUDA events.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the kernel table as JSON. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

F32_TOL = 3e-5
BF16_TOL = 2.0 ** -4
PSNR_BAR = 50.0
# x4 runs two bf16 stacks in a chain; each rounds its activations to bf16,
# and the second amplifies the first's error, so the single-stack 50 dB
# bar does not apply to the chain. The same chain with f32 kernels is
# held to 50 dB.
CHAIN_BAR = 45.0


def log(*args):
    print(*args, flush=True)


def timed_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def psnr1(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def structured_bgr(rng: np.random.Generator, n: int, h: int, w: int):
    """Seeded u8 BGR frames with image-like structure: a smooth random
    field (bilinear upscale of a coarse grid) plus sensor-like noise."""
    coarse = torch.from_numpy(rng.random((n, 3, h // 32 + 1, w // 32 + 1),
                                         dtype=np.float32))
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    img = smooth * 255.0 + rng.normal(0.0, 6.0, (n, h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.srcnn import (
        SRCNN, count_maccs_per_pixel, init_params)
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import _build, stack
    from waifu2x_torch.ops.s2d import d2s_host_cmajor
    from waifu2x_torch.pipeline import (
        Converter, FastStack, _to_bgr_u8, _to_yuv, scale2x_batch,
        scale2x_batch_u8_fused)
    from waifu2x_torch.utils.metrics import psnr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # 1. build
    t0 = time.perf_counter()
    _build.load("stack")
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    log("  " + nvcc.strip().splitlines()[-1])
    for name, (secs, out) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"  nvcc {name}.cu {secs:.2f} s; ptxas: " + " | ".join(regs))

    # 2. f32 kernel vs plain at small and odd shapes
    sp_rand = stack.prep_params(init_params(3), torch.float32, dev)
    gen = torch.Generator().manual_seed(0)
    for shape in [(2, 37, 53), (1, 8, 8), (2, 64, 96), (1, 5, 300)]:
        y = torch.rand(shape, generator=gen).to(dev)
        err = (stack.stack_scale(y, sp_rand)
               - stack.stack_scale_plain(y, sp_rand)).abs().max().item()
        log(f"phase 2 f32 {shape}: max|kernel - plain| = {err:.3e}")
        if not err <= F32_TOL:
            raise AssertionError(f"f32 kernel off by {err} at {shape}")

    # 3. the kernel vs its plain version at the main path's shape
    params = load_model_json(root / "models" / "scale2.0x_demo.json")
    sp32 = stack.prep_params(params, torch.float32, dev)
    sp16 = stack.prep_params(params, torch.bfloat16, dev)
    rng = np.random.default_rng(0)
    frames = structured_bgr(rng, 16, 512, 512)
    yuv = _to_yuv(torch.from_numpy(frames).to(dev))
    ylow = yuv[..., 0].contiguous()
    ylow16 = ylow.to(torch.bfloat16)
    ref32 = stack.stack_scale_plain(ylow, sp32)
    err32 = (stack.stack_scale(ylow, sp32) - ref32).abs().max().item()
    got16 = stack.stack_scale(ylow16, sp16)
    ref16 = stack.stack_scale_plain(ylow16, sp16).float()
    err16 = (got16.float() - ref16).abs().max().item()
    db16 = psnr1(got16.float(), ref32)
    log(f"phase 3 {tuple(ylow.shape)}: f32 max|kernel - plain| = "
        f"{err32:.3e}; bf16 max|kernel - bf16 plain| = {err16:.3e}; "
        f"bf16 kernel vs f32 plain {db16:.2f} dB")
    if not err32 <= F32_TOL:
        raise AssertionError(f"f32 kernel off by {err32} at the main shape")
    if not (err16 <= BF16_TOL and db16 >= PSNR_BAR):
        raise AssertionError(f"bf16 kernel: {err16} abs, {db16} dB")
    # the adversarial worst case for bf16 storage: a pure-random luma
    # plane, every pixel an edge (reported, not gated)
    noise = torch.rand((2, 512, 512), generator=gen).to(dev)
    db_noise = psnr1(
        stack.stack_scale(noise.to(torch.bfloat16), sp16).float(),
        stack.stack_scale_plain(noise, sp32))
    log(f"  bf16 kernel on a pure-random plane vs f32 plain: "
        f"{db_noise:.2f} dB")
    del ref32, ref16, got16, noise
    torch.cuda.empty_cache()

    # 4. the main path at full width
    fast = FastStack.build(params, True, dtype=torch.bfloat16, device=dev)
    stack.LAUNCHES = 0
    u8 = scale2x_batch_u8_fused(_to_yuv(torch.from_numpy(frames).to(dev)),
                                fast)
    launches = stack.LAUNCHES
    out = d2s_host_cmajor(u8.cpu().numpy())
    log(f"phase 4 main path: {frames.shape} -> {out.shape} {out.dtype}, "
        f"{launches} kernel launches")
    if launches != 7 or out.shape != (16, 1024, 1024, 3):
        raise AssertionError(f"main path: {launches} launches, {out.shape}")
    model32 = SRCNN.from_params(params).to(dev)
    cfg32 = Config(mode="scale", compute_dtype="float32")
    ref = _to_bgr_u8(scale2x_batch(yuv[:2], model32, cfg32)).cpu().numpy()
    db_main = psnr(out[:2], ref)
    log(f"  frames 0-1 vs f32 non-kernel path: {db_main:.2f} dB")
    if not db_main >= PSNR_BAR:
        raise AssertionError(f"main path at {db_main} dB")

    with tempfile.TemporaryDirectory() as mdir:
        shutil.copy(root / "models" / "scale2.0x_demo.json",
                    Path(mdir) / "scale2.0x_model.json")
        img = structured_bgr(rng, 1, 720, 1280)[0]
        refs = {}
        for ratio, dtype, bar in ((2.0, "auto", PSNR_BAR),
                                  (4.0, "auto", CHAIN_BAR),
                                  (4.0, "float32", PSNR_BAR)):
            if ratio not in refs:
                refs[ratio] = Converter.from_config(Config(
                    mode="scale", scale_ratio=ratio, model_dir=mdir,
                    use_pallas=False, compute_dtype="float32"),
                    dev).process_bgr_u8(img)
            want = refs[ratio]
            conv = Converter.from_config(Config(
                mode="scale", scale_ratio=ratio, model_dir=mdir,
                compute_dtype=dtype), dev)
            stack.LAUNCHES = 0
            got = conv.process_bgr_u8(img)
            n_conv = stack.LAUNCHES   # 7 per dispatch; tall planes band
            db = psnr(got, want)
            log(f"  Converter x{ratio:g} {dtype} {img.shape} -> {got.shape}: "
                f"{n_conv} launches, {db:.2f} dB vs f32 non-kernel path "
                f"(bar {bar:g})")
            if (n_conv < 7 * int(np.log2(ratio)) or n_conv % 7
                    or got.shape != want.shape or not db >= bar):
                raise AssertionError(f"Converter x{ratio} {dtype}: "
                                     f"{n_conv} launches, {db} dB")
            del conv, got
            torch.cuda.empty_cache()
        del refs

    # timings at the main path's shape (CUDA events, after a warm-up)
    yuv16 = _to_yuv(torch.from_numpy(frames).to(dev))
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    kernel_ms = timed_ms(lambda: stack.stack_scale(ylow16, sp16))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    per_layer = np.zeros(7)
    for _ in range(3):
        stack.stack_scale(ylow16, sp16, events=events)
        torch.cuda.synchronize()
        per_layer += [events[k].elapsed_time(events[k + 1]) / 3
                      for k in range(7)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_ms = timed_ms(lambda: stack.stack_scale_plain(ylow16, sp16))
    torch.cuda.empty_cache()
    # library yardstick (never called by the port): the same 7-conv stack
    # as cuDNN bf16 channels_last on the padded nearest-2x plane
    layers = [(w.float().reshape(w.shape[0], 3, 3, w.shape[2])
               .permute(3, 0, 1, 2).to(torch.bfloat16)
               .contiguous(memory_format=torch.channels_last),
               b.to(torch.bfloat16)) for w, b in sp16]
    xpad = F.pad(
        ylow16.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
        (7,) * 4, mode="replicate").contiguous(
            memory_format=torch.channels_last)

    def library_stack():
        h = xpad
        for w, b in layers:
            h = F.leaky_relu(F.conv2d(h, w, b), 0.1)
        return h

    library_ms = timed_ms(library_stack)
    del xpad, layers
    torch.cuda.empty_cache()

    n, hl, wl = ylow16.shape
    out_px = n * 4 * hl * wl
    flops = 2 * count_maccs_per_pixel() * out_px
    moved = ylow16.numel() * 2 + out_px * 2 + sum(
        w.numel() * 2 + b.numel() * 4 for w, b in sp16)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"timing {n} x {hl}x{wl} -> {2 * hl}x{2 * wl} bf16 on {smi}: "
        f"step {step_ms:.2f} ms = {out_px / step_ms / 1e3:.2f} MP/s; "
        f"kernel {kernel_ms:.2f} ms "
        f"({flops / kernel_ms / 1e9:.2f} TFLOP/s, bound {bound_ms:.2f} ms = "
        f"{100 * bound_ms / kernel_ms:.2f}% of roofline; FFMA floor "
        f"{flops / PEAK_F32_FLOPS * 1e3:.2f} ms); plain {plain_ms:.2f} ms; "
        f"cuDNN bf16 library {library_ms:.2f} ms; "
        f"peak memory {peak_gb:.2f} GB")
    # per layer: FLOPs over the planes it really computes (the padded
    # borders included) and its activation bytes, read once + written once
    rates, act_bytes = [], 0
    for k, (ms, (ci, co)) in enumerate(zip(per_layer, stack.WIDTHS)):
        hin, win = 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k
        flop_k = 2 * n * (hin - 2) * (win - 2) * ci * co * 9
        in_px = hl * wl if k == 0 else hin * win   # L1 reads the low-res
        bytes_k = 2 * n * (in_px * ci + (hin - 2) * (win - 2) * co)
        act_bytes += bytes_k
        rates.append(f"L{k + 1} {ms:.2f} ms {flop_k / ms / 1e9:.2f} TFLOP/s "
                     f"{bytes_k / ms / 1e6:.1f} GB/s")
    log("  per layer: " + "; ".join(rates))
    log(f"  activation traffic {act_bytes / 1e9:.2f} GB per batch = "
        f"{act_bytes / PEAK_BYTES * 1e3:.2f} ms at {PEAK_BYTES / 1e12} TB/s")

    kernels = [{
        "name": "conv3x3_bias_leaky (stack_scale, B1)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/stack.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": launches,
        "max_abs_err": err16,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
