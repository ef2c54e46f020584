"""GPU smoke run of the waifu2x_torch port: builds the CUDA kernels, holds
the conv stack's scale (B1) and noise (B2) input modes, its last layer's
dense (B6) and u8 (B3) output forms, its truncated form (B7) and layer 6 as
int8 (B4) and as Winograd (B5) against their plain PyTorch versions, drives
the scale, noise and noise->scale paths and the frame-stream runtime at full
model width, with layer 6 in each of its forms, and prints their numbers.

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Phases (any failure raises and exits non-zero):
  1. build csrc/stack.cu and csrc/l6.cu with nvcc for sm_90a, both at
     once (ops/_build.py);
  2. f32 scale kernel vs plain version at small and odd shapes:
     max |diff| <= 3e-5;
  3. the scale kernel vs its plain version at the scale512 shape
     (16 x 512^2 low-res): f32 max |diff| <= 3e-5; bf16 max |diff| against
     the bf16 plain version <= 2^-4 (rounding ties flip a bf16 unit at
     some layer and propagate), and >= 50 dB PSNR (peak 1) against the
     f32 plain version;
  4. the scale512 main path with the shipped scale2.0x weights on 16
     seeded 512 x 512 BGR u8 frames: _to_yuv -> scale2x_batch_u8_fused ->
     d2s_host_cmajor, with the launch counter read around it; frames 0-1
     >= 50 dB against the port's f32 non-kernel path; then
     Converter.process_bgr_u8 on a 720 x 1280 image against the f32
     non-kernel Converter: x2 (bf16 kernel) >= 50 dB, x4 (two chained bf16
     stacks) >= 45 dB, x4 with f32 kernels >= 50 dB;
  5. the f32 noise kernel (stack_noise, and stack_noise_s2d at even
     shapes) vs its plain version at small and odd shapes: <= 3e-5; at the
     noise256 shape with the shipped noise1 weights: f32 <= 3e-5, bf16
     <= 2^-4 against the bf16 plain version and >= 50 dB against f32;
  6. the noise256 main path: 256 seeded 256 x 256 u8 frames with the
     noise1 weights, _to_yuv -> noise_batch_u8_fused -> d2s_host_cmajor at
     7 launches; frames 0-1 >= 50 dB against the f32 non-kernel noise_batch;
  7. the ns1080 chain: 4 seeded 1080 x 1920 frames with the noise2 and
     scale2.0x weights, noise_y_batch_fast(out_dtype=None) handed to
     scale2x_batch_u8_fused(y=...) at 14 launches; each of the 4 frames
     against the f32 non-kernel chain: >= 45 dB with both stacks bf16,
     >= 50 dB with an f32 noise stack and a bf16 scale stack (the
     Converter's auto policy);
  8. Converter mode="noise" (levels 1 and 2) and mode="noise_scale" under
     compute_dtype="auto" on a 720 x 1280 and an odd 721 x 1279 image:
     >= 50 dB against the f32 non-kernel Converter, launches a multiple of 7.
  9. the last layer's other output forms, f32 and bf16, at small and odd
     shapes and at scale512: stack_scale_dense un-chunked bit-equal to
     stack_scale, its pad columns zero, f32 within 3e-5 of its plain
     version; stack_scale_fused_u8 against its plain version: f32 |diff|
     <= 1 u8 level at < 0.5% of bytes, bf16 |diff| <= 15 levels (the 2^-4
     of the Y forms) and at scale512 >= 50 dB against the f32 plain
     version, lanes 12:16 zero; against the default tail on the scale512
     frames: f32 |diff| <= 1 at < 0.5%, bf16 |diff| <= 1 (the two round
     the same Y at another place) and PSNR against the f32 non-kernel
     path no lower than the default tail's less 0.1 dB;
 10. the scale stream, StreamConverter.process_frames on 64 seeded 512 x
     512 frames at batch 16, depth 2: with the default tail, with YDENSE
     (equal to the default bit for bit) and with FUSED_TAIL="kernel" (the
     stream's main path): every frame equal to the batch step's on the same
     batch, 7 launches per dispatch, frames 0-1 >= 50 dB against the f32
     non-kernel path;
 11. the noise stream (512 frames of 256 x 256 at batch 256, then an odd
     255 x 257 frame among even ones), the noise_scale stream built by
     from_params (8 frames of 1080 x 1920 at batch 8, which the volume cap
     cuts to 4; f32 noise stack; each frame >= 50 dB against the f32
     non-kernel chain) and a stream of three frame sizes interleaved
     (tail batches padded, output order equal to input order).
 12. the truncated stack (B7), stack_scale_upto for upto = 0..6 at (2,37,53),
     (1,5,300) and scale512, f32 and bf16, against its plain version: f32
     <= 3e-5, bf16 <= 2^-4; upto + 1 launches per call;
 13. Winograd layer 6 (B5), l6_wino=True, scale and noise input modes, at
     the small and odd shapes, scale512 and noise256: f32 <= 3e-5 against
     its plain version and <= 1e-4 against the direct kernel; bf16 <= 2^-4
     against the bf16 plain version and, at the two main shapes, >= 50 dB
     against the f32 plain version;
 14. int8 layer 6 (B4), l6_i8=True, at equal tile, scale and noise input
     modes, a grid that pads both ways, a single tile, scale512 and
     noise256: (a) layer 6 alone, kernel and plain version fed the same
     stored layer-5 plane: the quantised values and the int32 sums are then
     the same on both sides, so f32 <= 3e-5 and bf16 <= 2^-4 with no
     allowance for ties, and the tiles' scales equal bit for bit; (b) the
     whole stack: a quantiser tie that the f32 summation order of layers
     1-5 flips moves one int8 step, so in f32 kernel - plain is held
     against int8 - direct on the same input, its rms to a tenth and its
     max to a quarter, with at most 10% of outputs over 1e-5; in bf16 it
     is held to 2^-4;
 15. the product paths at full width under each layer-6 switch (stack.L6_WINO,
     stack.L6_I8): the scale512 batch step, the 64-frame scale512 stream
     under W2X_TAIL=kernel (equal to the batch step bit for bit, launches
     counted by kind and by layer-6 form) and the noise256 batch step;
     frames 0-1 against the f32 non-kernel path: Winograd no lower than the
     direct form on the same frames less 1.5 dB (its U is rounded to bf16,
     the one rounding the direct form lacks) and reported against the 50 dB
     bar; int8 printed beside the QAT proxy (train.qat.l6_quant_gap_db)
     and held to >= 35 dB only: the shipped weights were not trained for
     int8, and the JAX package ships the mode opt-in for that reason. Then
     the two entry points that drive these configurations directly,
     tools.layer_time_probe (the upto ladder at the scale512 shape) and
     tools.i8_fidelity_probe.
In phases 4, 6-8, 10-11 and 15 every call that the run made to a kernel wrapper
(one per wrapper, input shape, dtype and weights) is repeated on a copy of
its input and held against the plain version: f32 max |diff| <= 3e-5; bf16
max |diff| <= 2^-4 against the bf16 plain version and >= 50 dB against the
f32 plain version with the model's f32 weights; the u8 wrapper at phase 9's
bars; the dense wrapper also bit-equal to stack_scale; under the int8 switch the
bf16 bar against the f32 plain version is phase 15's 35 dB.
Calls on frames of more than 1 M pixels are held on their first frame. Then
timings with CUDA events for scale512 (each tail, each last-layer form,
each layer-6 form, the truncation's own launches), noise256 and ns1080,
cuDNN bf16 yardsticks the port never calls, and for each stream its wall
time beside the sum of its device step times.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the kernel table as JSON (u8 kernels give max_abs_err in u8 levels).
Without a CUDA card it exits non-zero and prints no result.
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
PEAK_INT8_OPS = 1979e12
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
# The u8 kernel and its plain version take the same f32 steps from Y to the
# byte (the kernel's colour map is written without fmaf), so they differ
# only where the convolutions' summation order moves a value across a
# rounding tie: one level, at few bytes.
U8_MAX = 1
U8_FRAC = 0.005
# In bf16 storage a tie flips a bf16 unit of some activation and the flip
# propagates, as in the Y-output forms: their bar on Y, BF16_TOL, in u8
# levels, with no bar on how many bytes differ (the count is printed).
U8_BF16_MAX = int(BF16_TOL * 255)
# Winograd against the direct kernel in f32: two factorisations of one
# layer, each within F32_TOL of its own plain version; the JAX suite holds
# the same pair to 1e-5 at 32 x 32 with unit-scale random weights.
WINO_VS_DIRECT_TOL = 1e-4
WINO_DB_SLACK = 1.5   # dB under the direct form on the same frames
I8_BAR = 35.0         # dB, int8 with weights that were not trained for it
# The int8 kernel against its plain version over a whole stack, in f32: the
# two quantise the same layer-5 values except where the summation order of
# layers 1-5 moves one across a rounding tie of the quantiser, and such a
# flip moves one int8 step. Held against what int8 itself costs on the same
# input (int8 - direct): the rms to a tenth, the largest single difference
# to a quarter (one flip against the sum of a window's rounding errors; the
# largest of 16.7 M outputs measured 0.12 of it at scale512, 0.05 at the
# small shapes), and the share of outputs that move by over 1e-5 to 10%
# (measured 1.7-2.9%; an error in the arithmetic would move them all).
I8_TIE_RMS = 0.1
I8_TIE_MAX = 0.25
I8_TIE_OUTPUTS = 0.1


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


def check_max_err(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{what}: max |diff| {err} > {tol}")


def check_u8(what: str, got: torch.Tensor, ref: torch.Tensor,
             max_level: int = U8_MAX, max_frac: float = U8_FRAC):
    """Hold two u8 tensors to |diff| <= max_level at under max_frac of
    bytes; returns (max |diff|, fraction of bytes that differ)."""
    if (got.shape != ref.shape or got.dtype != torch.uint8
            or ref.dtype != torch.uint8):
        raise AssertionError(f"{what}: {got.shape} {got.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    worst, frac = diff.max().item(), (diff != 0).float().mean().item()
    if not (worst <= max_level and frac < max_frac):
        raise AssertionError(f"{what}: max |diff| {worst}, {frac:.3%} of "
                             f"bytes differ")
    return worst, frac


def check_u8_kernel(what: str, got, ref, dtype):
    """check_u8 at the u8 kernel's bar against its plain version: f32 one
    level at under U8_FRAC of bytes, bf16 U8_BF16_MAX levels."""
    if dtype == torch.float32:
        return check_u8(what, got, ref)
    return check_u8(what, got, ref, U8_BF16_MAX, 1.01)


def check_lanes_zero(what: str, u8: torch.Tensor) -> None:
    if u8[..., 12:].any().item():
        raise AssertionError(f"{what}: lanes 12:16 are not all zero")


def check_dense_pad(what: str, ydense: torch.Tensor, tc: int, wl: int):
    n, hl, wd = ydense.shape
    nx = wd // (4 * tc)
    pad = ydense.reshape(n, hl, nx, 4, tc)[:, :, -1, :, wl - (nx - 1) * tc:]
    if nx != -(-wl // tc) or pad.any().item():
        raise AssertionError(f"{what}: pad columns are not all zero")


# wrapper -> position of the weights among its arguments
WRAPPERS = {"stack_scale": 1, "stack_noise_s2d": 1, "stack_noise": 1,
            "stack_scale_dense": 1, "stack_scale_fused_u8": 2}
HOLD_PX = 1e6   # calls on larger frames are held on their first frame


def record_wrapper_calls(pipeline_mod, seen: dict):
    """Route the pipeline's calls of the stack wrappers through a recorder
    that keeps a copy of the first tensor arguments at each (wrapper,
    shape, dtype, weights) in `seen`. Returns a function that restores the
    wrappers."""
    orig = {name: getattr(pipeline_mod, name) for name in WRAPPERS}

    def recorder(name):
        def call(*args, **kw):
            x, sp = args[0], args[WRAPPERS[name]]
            key = (name, tuple(x.shape), x.dtype, id(sp))
            if key not in seen:
                seen[key] = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
            return orig[name](*args, **kw)
        return call

    for name in WRAPPERS:
        setattr(pipeline_mod, name, recorder(name))
    return lambda: [setattr(pipeline_mod, n, f) for n, f in orig.items()]


def in_chunks(fn, x: torch.Tensor, scale: bool) -> torch.Tensor:
    """torch.cat of fn(i0, i1) over frame ranges sized so that a plain
    version's 128-channel f32 activations stay near 4 GB (the plain
    versions are frame-independent)."""
    out_px = x.shape[1] * x.shape[2] * (4 if scale else 1)
    c = max(1, int(4e9 // (128 * 4 * out_px)))
    return torch.cat([fn(i, i + c) for i in range(0, x.shape[0], c)])


def plain_in_chunks(plain, x: torch.Tensor, sp, scale: bool) -> torch.Tensor:
    """plain(x, sp) as f32, a few frames at a time."""
    return in_chunks(lambda i, j: plain(x[i:j], sp).float(), x, scale)


def hold_seen(seen: dict, stack, f32_twin, max_err: dict,
              psnr_bar: float = PSNR_BAR) -> None:
    """Repeat every recorded wrapper call on its input and hold the kernel
    against its plain version: f32 max |diff| <= F32_TOL; bf16 max |diff|
    <= BF16_TOL against the bf16 plain version and >= psnr_bar against the
    f32 plain version with the model's f32 weights (both sides with layer 6
    in the form the stack module's switches select). stack_scale_dense is
    un-chunked first and must also equal stack_scale bit for bit;
    stack_scale_fused_u8 is held by check_u8_kernel, its bf16 form also
    to PSNR_BAR (peak 255) against the f32 plain version. Calls on frames of
    more than HOLD_PX pixels are held on their first frame. `max_err` collects
    the largest |diff| per wrapper."""
    for (name, shape, dtype, _), args in seen.items():
        x, sp = args[0], args[WRAPPERS[name]]
        if x.shape[1] * x.shape[2] > HOLD_PX:
            x = x[:1].contiguous()
        n, hl, wl = x.shape
        msg = f"  held {name} {tuple(x.shape)} of {shape} {dtype}: "
        if name == "stack_scale_fused_u8":
            uvp = args[1][:n].contiguous()
            got = stack.stack_scale_fused_u8(x, uvp, sp)
            check_lanes_zero(f"{name} at {shape}", got)
            err, frac = check_u8_kernel(f"{name} at {shape}", got, in_chunks(
                lambda i, j: stack.stack_scale_fused_u8_plain(
                    x[i:j], uvp[i:j], sp), x, True), dtype)
            msg += f"max|kernel - plain| = {err} level, {frac:.4%} of bytes"
            if dtype != torch.float32:
                sp32 = f32_twin(sp)
                db = 20 * np.log10(255.0) + psnr1(got, in_chunks(
                    lambda i, j: stack.stack_scale_fused_u8_plain(
                        x[i:j].float(), uvp[i:j], sp32), x, True))
                msg += f"; vs f32 plain {db:.2f} dB"
                if not db >= psnr_bar:
                    raise AssertionError(f"bf16 {name} at {shape}: {db} dB")
        else:
            plain_name, scale = name + "_plain", name == "stack_scale"
            if name == "stack_scale_dense":
                ydense, tc = stack.stack_scale_dense(x, sp, *args[2:])
                check_dense_pad(f"{name} at {shape}", ydense, tc, wl)
                got = stack.dense_to_s2d(ydense, tc, hl, wl)
                if not torch.equal(got, stack.stack_scale(x, sp)):
                    raise AssertionError(f"{name} at {shape}: un-chunked "
                                         f"output differs from stack_scale")
                msg += "bit-equal to stack_scale; "
                plain_name, scale = "stack_scale_plain", True
                got = got.float()
            else:
                got = getattr(stack, name)(x, sp).float()
            plain = getattr(stack, plain_name)
            err = (got - plain_in_chunks(plain, x, sp, scale)
                   ).abs().max().item()
            msg += f"max|kernel - plain| = {err:.3e}"
            if dtype == torch.float32:
                check_max_err(f"{name} at {shape}", err, F32_TOL)
            else:
                db = psnr1(got, plain_in_chunks(plain, x.float(),
                                                f32_twin(sp), scale))
                msg += f"; vs f32 plain {db:.2f} dB"
                if not (err <= BF16_TOL and db >= psnr_bar):
                    raise AssertionError(f"bf16 {name} at {shape}: {err} "
                                         f"abs, {db} dB")
        max_err[name] = max(max_err.get(name, 0.0), err)
        log(msg)
        del got
        torch.cuda.empty_cache()
    seen.clear()


def run_stream(sc, frames, stack, label: str, smi: str):
    """Drive sc.process_frames(frames) once with the launch counts set to
    0 just before, timing each dispatch's device step with CUDA events and,
    on the host's clock, the time spent inside _dispatch (the pinned fill
    and every enqueue) and inside _interleave. Returns (outputs, launches
    by kernel configuration, dispatches)."""
    steps, host_s = [], {"dispatch": 0.0, "interleave": 0.0}
    step, dispatch, interleave = sc._step, sc._dispatch, sc._interleave

    def timed_step(yuv):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(yuv)
        ev[1].record()
        steps.append(ev)
        return out

    def on_host(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host_s[name] += time.perf_counter() - t0
            return out
        return call

    sc._step = timed_step
    sc._dispatch = on_host("dispatch", dispatch)
    sc._interleave = on_host("interleave", interleave)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stack.reset_launches()
    t0 = time.perf_counter()
    outs = list(sc.process_frames(frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(stack.KERNEL_LAUNCHES)
    sc._step, sc._dispatch, sc._interleave = step, dispatch, interleave
    if sum(counts.values()) != stack.LAUNCHES:
        raise AssertionError(f"{label}: launch counts {counts} do not add "
                             f"up to {stack.LAUNCHES}")
    dev_s = sum(a.elapsed_time(b) for a, b in steps) / 1e3
    out_px = sum(o.shape[0] * o.shape[1] for o in outs)
    log(f"stream {label} on {smi}: {len(frames)} frames in {len(steps)} "
        f"dispatches, launches {counts}; wall {wall:.3f} s = "
        f"{len(frames) / wall:.2f} frames/s = {out_px / wall / 1e6:.2f} "
        f"output MP/s; device steps {dev_s:.3f} s "
        f"({100 * dev_s / wall:.1f}% of wall, host share "
        f"{wall - dev_s:.3f} s); host time in dispatch "
        f"{host_s['dispatch']:.3f} s, in interleave "
        f"{host_s['interleave']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if len(outs) != len(frames):
        raise AssertionError(f"{label}: {len(outs)} outputs for "
                             f"{len(frames)} frames")
    return outs, counts, len(steps)


def per_layer_ms(run, stack) -> np.ndarray:
    """Per-layer device ms of run(events) (a wrapper call that records 8
    CUDA events), averaged over 3 runs after the caller's warm-up."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    ms = np.zeros(len(stack.WIDTHS))
    for _ in range(3):
        run(events)
        torch.cuda.synchronize()
        ms += [events[k].elapsed_time(events[k + 1]) / 3
               for k in range(len(stack.WIDTHS))]
    return ms


def layer_rates(ms_per_layer, stack, n, hl, wl, l1_in_px, itemsize=2):
    """Per layer: FLOPs over the planes it really computes (the padded
    borders included) and its activation bytes, read once + written once.
    Returns (one-line report, activation bytes per call)."""
    rates, act_bytes = [], 0
    for k, (ms, (ci, co)) in enumerate(zip(ms_per_layer, stack.WIDTHS)):
        hin, win = 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k
        flop_k = 2 * n * (hin - 2) * (win - 2) * ci * co * 9
        in_px = l1_in_px if k == 0 else hin * win
        bytes_k = itemsize * n * (in_px * ci + (hin - 2) * (win - 2) * co)
        act_bytes += bytes_k
        rates.append(f"L{k + 1} {ms:.2f} ms {flop_k / ms / 1e9:.2f} TFLOP/s "
                     f"{bytes_k / ms / 1e6:.1f} GB/s")
    return "; ".join(rates), act_bytes


def library_stack_ms(plane16: torch.Tensor, sp16, post=None) -> float:
    """Library yardstick (never called by the port): the same 7-conv stack
    as cuDNN bf16 channels_last on a plane already replicate-padded by 7
    ([N, H, W] bf16), followed by post(Y [N, H-14, W-14]) where given."""
    layers = [(w.float().reshape(w.shape[0], 3, 3, w.shape[2])
               .permute(3, 0, 1, 2).to(torch.bfloat16)
               .contiguous(memory_format=torch.channels_last),
               b.to(torch.bfloat16)) for w, b in sp16]
    xpad = plane16[:, None].contiguous(memory_format=torch.channels_last)

    def library_stack():
        h = xpad
        for w, b in layers:
            h = F.leaky_relu(F.conv2d(h, w, b), 0.1)
        return h if post is None else post(h[:, 0])

    ms = timed_ms(library_stack)
    del xpad, layers
    torch.cuda.empty_cache()
    return ms


def stack_bound(plane: torch.Tensor, out_px: int, sp, maccs: int,
                io_bytes: "int | None" = None):
    """(bound ms, bound_by, FLOPs) of one stack call: its FLOPs at the bf16
    peak against the bytes it must move (the input plane, the weights and Y,
    each once) at the memory rate. `io_bytes` replaces the bytes of the
    plane and Y where a call reads or writes other arrays."""
    item = plane.element_size()
    flops = 2 * maccs * out_px
    if io_bytes is None:
        io_bytes = plane.numel() * item + out_px * item
    moved = io_bytes + sum(
        w.numel() * w.element_size() + b.numel() * 4 for w, b in sp)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


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
    from waifu2x_torch import pipeline as pipeline_mod
    from waifu2x_torch.ops import _build, stack
    from waifu2x_torch.ops.s2d import d2s_host_cmajor, s2d
    from waifu2x_torch.pipeline import (
        Converter, FastStack, _tail_u8_cmajor, _to_bgr_u8, _to_yuv,
        _uv_phases_cmajor, noise_batch, noise_batch_u8_fused,
        noise_y_batch_fast, scale2x_batch, scale2x_batch_u8_fused)
    from waifu2x_torch.stream import StreamConverter
    from waifu2x_torch.utils.metrics import psnr

    t_start = time.perf_counter()
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
    _build.load("stack", "l6")
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
        check_max_err(f"f32 scale kernel at {shape}", err, F32_TOL)

    # 3. the kernel vs its plain version at the main path's shape
    params = load_model_json(root / "models" / "scale2.0x_demo.json")
    params_n1 = load_model_json(root / "models" / "noise1_demo.json")
    params_n2 = load_model_json(root / "models" / "noise2_demo.json")
    # (bf16, f32) weights of each shipped model, for the held calls' f32
    # comparison
    twins = [(stack.prep_params(p, torch.bfloat16, dev),
              stack.prep_params(p, torch.float32, dev))
             for p in (params, params_n1, params_n2)]
    (sp16, sp32), (spn16, spn32) = twins[0], twins[1]

    def f32_twin(sp):
        if sp[0][0].dtype == torch.float32:
            return sp
        for s16, s32 in twins:
            if all(torch.equal(a[0], b[0]) for a, b in zip(sp, s16)):
                return s32
        raise AssertionError("bf16 weights of no shipped model")

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
    check_max_err("f32 scale kernel at the main shape", err32, F32_TOL)
    if not (err16 <= BF16_TOL and db16 >= PSNR_BAR):
        raise AssertionError(f"bf16 kernel: {err16} abs, {db16} dB")
    max_err = {"stack_scale": max(err32, err16)}
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

    # 4. the main path at full width. From here to the end of phase 8 the
    # pipeline's wrapper calls are recorded, and after each run every one
    # is held against its plain version on the same input (hold_seen).
    seen = {}
    restore_wrappers = record_wrapper_calls(pipeline_mod, seen)
    fast = FastStack.build(params, True, dtype=torch.bfloat16, device=dev)
    stack.reset_launches()
    u8 = scale2x_batch_u8_fused(_to_yuv(torch.from_numpy(frames).to(dev)),
                                fast)
    launches = stack.LAUNCHES
    out = d2s_host_cmajor(u8.cpu().numpy())
    log(f"phase 4 main path: {frames.shape} -> {out.shape} {out.dtype}, "
        f"{launches} kernel launches")
    if launches != 7 or out.shape != (16, 1024, 1024, 3):
        raise AssertionError(f"main path: {launches} launches, {out.shape}")
    hold_seen(seen, stack, f32_twin, max_err)
    model32 = SRCNN.from_params(params).to(dev)
    cfg32 = Config(mode="scale", compute_dtype="float32")
    ref_main = _to_bgr_u8(scale2x_batch(yuv[:2], model32,
                                        cfg32)).cpu().numpy()
    db_main = psnr(out[:2], ref_main)
    log(f"  frames 0-1 vs f32 non-kernel path: {db_main:.2f} dB")
    if not db_main >= PSNR_BAR:
        raise AssertionError(f"main path at {db_main} dB")
    del u8, out
    torch.cuda.empty_cache()

    mdir_obj = tempfile.TemporaryDirectory()
    mdir = mdir_obj.name
    for demo, name in (("scale2.0x", "scale2.0x"), ("noise1", "noise1"),
                       ("noise2", "noise2")):
        shutil.copy(root / "models" / f"{demo}_demo.json",
                    Path(mdir) / f"{name}_model.json")
    img = structured_bgr(rng, 1, 720, 1280)[0]

    def converter_check(cfg_kw: dict, img: np.ndarray, bar: float,
                        min_launches: int, ref: np.ndarray) -> float:
        conv = Converter.from_config(Config(model_dir=mdir, **cfg_kw), dev)
        stack.reset_launches()
        got = conv.process_bgr_u8(img)
        n_conv = stack.LAUNCHES   # 7 per dispatch; tall planes band
        db = psnr(got, ref)
        log(f"  Converter {cfg_kw} {img.shape} -> {got.shape}: {n_conv} "
            f"launches, {db:.2f} dB vs f32 non-kernel path (bar {bar:g})")
        if (n_conv < min_launches or n_conv % 7 or got.shape != ref.shape
                or not db >= bar):
            raise AssertionError(f"Converter {cfg_kw}: {n_conv} launches, "
                                 f"{db} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        del conv, got
        torch.cuda.empty_cache()
        return db

    def converter_ref(cfg_kw: dict, img: np.ndarray) -> np.ndarray:
        return Converter.from_config(Config(
            model_dir=mdir, use_pallas=False, compute_dtype="float32",
            **cfg_kw), dev).process_bgr_u8(img)

    refs = {}
    for ratio, dtype, bar in ((2.0, "auto", PSNR_BAR),
                              (4.0, "auto", CHAIN_BAR),
                              (4.0, "float32", PSNR_BAR)):
        kw = dict(mode="scale", scale_ratio=ratio)
        if ratio not in refs:
            refs[ratio] = converter_ref(kw, img)
        converter_check(dict(kw, compute_dtype=dtype), img, bar,
                        7 * int(np.log2(ratio)), refs[ratio])
    del refs

    # 5. the noise kernel (B2) vs its plain version
    for shape in [(1, 27, 38), (2, 37, 53), (1, 5, 300), (1, 8, 8)]:
        y = torch.rand(shape, generator=gen).to(dev)
        err = (stack.stack_noise(y, sp_rand)
               - stack.stack_noise_plain(y, sp_rand)).abs().max().item()
        msg = f"phase 5 f32 noise {shape}: max|kernel - plain| = {err:.3e}"
        check_max_err(f"f32 noise kernel at {shape}", err, F32_TOL)
        max_err["stack_noise"] = max(max_err.get("stack_noise", 0.0), err)
        if shape[1] % 2 == 0 and shape[2] % 2 == 0:
            err = (stack.stack_noise_s2d(y, sp_rand)
                   - stack.stack_noise_s2d_plain(y, sp_rand)
                   ).abs().max().item()
            msg += f"; s2d {err:.3e}"
            check_max_err(f"f32 noise_s2d kernel at {shape}", err, F32_TOL)
            max_err["stack_noise_s2d"] = max(
                max_err.get("stack_noise_s2d", 0.0), err)
        log(msg)

    frames_n = structured_bgr(rng, 256, 256, 256)
    yuv_n = _to_yuv(torch.from_numpy(frames_n).to(dev))
    yn = yuv_n[..., 0].contiguous()
    yn16 = yn.to(torch.bfloat16)
    ref32 = stack.stack_noise_s2d_plain(yn, spn32)
    errn32 = (stack.stack_noise_s2d(yn, spn32) - ref32).abs().max().item()
    got16 = stack.stack_noise_s2d(yn16, spn16)
    errn16 = (got16.float() - stack.stack_noise_s2d_plain(yn16, spn16)
              .float()).abs().max().item()
    dbn16 = psnr1(got16.float(), ref32)
    log(f"phase 5 noise {tuple(yn.shape)}: f32 max|kernel - plain| = "
        f"{errn32:.3e}; bf16 max|kernel - bf16 plain| = {errn16:.3e}; "
        f"bf16 kernel vs f32 plain {dbn16:.2f} dB")
    check_max_err("f32 noise kernel at noise256", errn32, F32_TOL)
    if not (errn16 <= BF16_TOL and dbn16 >= PSNR_BAR):
        raise AssertionError(f"bf16 noise kernel: {errn16} abs, {dbn16} dB")
    max_err["stack_noise_s2d"] = max(max_err.get("stack_noise_s2d", 0.0),
                                     errn32, errn16)
    del ref32, got16
    torch.cuda.empty_cache()

    # 6. the noise256 main path at full width
    fast_n1 = FastStack.build(params_n1, False, dtype=torch.bfloat16,
                              device=dev)
    stack.reset_launches()
    u8 = noise_batch_u8_fused(_to_yuv(torch.from_numpy(frames_n).to(dev)),
                              fast_n1)
    launches_n = stack.LAUNCHES
    out = d2s_host_cmajor(u8.cpu().numpy())
    log(f"phase 6 noise256 main path: {frames_n.shape} -> {out.shape} "
        f"{out.dtype}, {launches_n} kernel launches")
    if launches_n != 7 or out.shape != frames_n.shape:
        raise AssertionError(f"noise256: {launches_n} launches, {out.shape}")
    hold_seen(seen, stack, f32_twin, max_err)
    modeln32 = SRCNN.from_params(params_n1).to(dev)
    cfgn32 = Config(mode="noise", compute_dtype="float32")
    ref_n256 = _to_bgr_u8(noise_batch(yuv_n[:2], modeln32,
                                      cfgn32)).cpu().numpy()
    db_n256 = psnr(out[:2], ref_n256)
    log(f"  frames 0-1 vs f32 non-kernel noise_batch: {db_n256:.2f} dB")
    if not db_n256 >= PSNR_BAR:
        raise AssertionError(f"noise256 main path at {db_n256} dB")
    del u8, out
    torch.cuda.empty_cache()

    # 7. the ns1080 chain: noise2 -> scale2.0x on 4 1080p frames
    frames_c = structured_bgr(rng, 4, 1080, 1920)
    yuv_c = _to_yuv(torch.from_numpy(frames_c).to(dev))
    modeln2_32 = SRCNN.from_params(params_n2).to(dev)
    cfgn2_32 = Config(mode="noise", compute_dtype="float32")
    ref_chain = np.concatenate([_to_bgr_u8(scale2x_batch(
        noise_batch(yuv_c[i:i + 1], modeln2_32, cfgn2_32), model32, cfg32))
        .cpu().numpy() for i in range(len(frames_c))])   # a frame at a time
    ref = ref_chain
    torch.cuda.empty_cache()
    fast_n2 = {dt: FastStack.build(params_n2, False, dtype=dt, device=dev)
               for dt in (torch.bfloat16, torch.float32)}

    def chain(fast_noise):
        y = noise_y_batch_fast(yuv_c[..., 0], fast_noise, out_dtype=None)
        return scale2x_batch_u8_fused(yuv_c, fast, y=y)

    db_chain = {}
    for dt, bar in ((torch.bfloat16, CHAIN_BAR), (torch.float32, PSNR_BAR)):
        stack.reset_launches()
        u8 = chain(fast_n2[dt])
        launches_c = stack.LAUNCHES
        out = d2s_host_cmajor(u8.cpu().numpy())
        db_frames = [psnr(out[i], ref[i]) for i in range(len(ref))]
        db_chain[dt] = min(db_frames)
        log(f"phase 7 ns1080 chain, {dt} noise / bf16 scale: "
            f"{tuple(u8.shape)} u8, {launches_c} kernel launches, frames 0-3 "
            + " / ".join(f"{db:.2f}" for db in db_frames)
            + f" dB vs the f32 non-kernel chain (bar {bar:g} each)")
        if (launches_c != 14 or tuple(u8.shape) != (4, 1080, 1920, 16)
                or not db_chain[dt] >= bar):
            raise AssertionError(f"ns1080 chain {dt}: {launches_c} launches, "
                                 f"{db_frames} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        out_chain = out    # the f32-noise chain's frames, for phase 11
        del u8, out
        torch.cuda.empty_cache()
    del ref

    # 8. Converter noise / noise_scale, auto policy, even and odd images
    img_odd = structured_bgr(rng, 1, 721, 1279)[0]
    for kw, min_l in ((dict(mode="noise", noise_level=1), 7),
                      (dict(mode="noise", noise_level=2), 7),
                      (dict(mode="noise_scale", noise_level=1), 14)):
        for im in (img, img_odd):
            converter_check(dict(kw, compute_dtype="auto"), im, PSNR_BAR,
                            min_l, converter_ref(kw, im))

    # 9. the last layer's other output forms: dense Y (B6), u8 BGR (B3)
    sp_rand16 = stack.prep_params(init_params(3), torch.bfloat16, dev)
    cases = [(torch.rand(shape, generator=gen).to(dev), None)
             for shape in [(2, 37, 53), (1, 8, 8), (1, 5, 300)]]
    cases.append((ylow, _uv_phases_cmajor(yuv)))       # scale512
    for y32, uvp in cases:
        shape = tuple(y32.shape)
        _, hl, wl = shape
        main_shape = uvp is not None
        if not main_shape:
            uvp = _uv_phases_cmajor(
                torch.rand((*shape, 3), generator=gen).to(dev))
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sp = ((sp32 if f32 else sp16) if main_shape
                  else (sp_rand if f32 else sp_rand16))
            y = y32.to(dt)
            ydense, tc = stack.stack_scale_dense(y, sp)
            check_dense_pad(f"dense at {shape}", ydense, tc, wl)
            y_s2d = stack.stack_scale(y, sp)
            if not torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), y_s2d):
                raise AssertionError(f"dense at {shape} {dt}: un-chunked "
                                     f"output differs from stack_scale")
            msg = (f"phase 9 {shape} {dt}: dense (tc {tc}) un-chunked == "
                   f"stack_scale, pad zero")
            if f32 and not main_shape:
                err = (ydense - stack.stack_scale_dense_plain(y, sp, tc)[0]
                       ).abs().max().item()
                check_max_err(f"f32 dense kernel at {shape}", err, F32_TOL)
                max_err["stack_scale_dense"] = max(
                    max_err.get("stack_scale_dense", 0.0), err)
                msg += f", max|kernel - plain| = {err:.3e}"
            got = stack.stack_scale_fused_u8(y, uvp, sp)
            check_lanes_zero(f"u8 kernel at {shape}", got)
            worst, frac = check_u8_kernel(
                f"u8 kernel at {shape} {dt}", got, in_chunks(
                    lambda i, j: stack.stack_scale_fused_u8_plain(
                        y[i:j], uvp[i:j], sp), y, True), dt)
            max_err["stack_scale_fused_u8"] = max(
                max_err.get("stack_scale_fused_u8", 0.0), worst)
            msg += (f"; u8 max|kernel - plain| = {worst} level at "
                    f"{frac:.4%} of bytes")
            if main_shape:
                tail = _tail_u8_cmajor(y_s2d, yuv)
                if f32:
                    worst, frac = check_u8("f32 kernel tail vs default tail",
                                           got, tail)
                    msg += (f"; vs the default tail {worst} level at "
                            f"{frac:.4%} of bytes")
                else:
                    db = 20 * np.log10(255.0) + psnr1(got, in_chunks(
                        lambda i, j: stack.stack_scale_fused_u8_plain(
                            y32[i:j], uvp[i:j], sp32), y, True))
                    msg += f"; vs f32 plain {db:.2f} dB"
                    if not db >= PSNR_BAR:
                        raise AssertionError(f"bf16 u8 kernel: {db} dB")
                    # the default tail maps the bf16 rounding of the same
                    # f32 Y: half a bf16 unit of Y, under one level
                    worst, frac = check_u8("bf16 kernel tail vs default tail",
                                           got, tail, 1, 1.01)
                    msg += (f"; vs the default tail {worst} level at "
                            f"{frac:.4%} of bytes")
                    db_k, db_x = (psnr(d2s_host_cmajor(
                        t[:2].cpu().numpy()), ref_main) for t in (got, tail))
                    msg += (f"; frames 0-1 vs f32 non-kernel path: kernel "
                            f"tail {db_k:.2f} dB, default tail {db_x:.2f} dB")
                    if not db_k >= db_x - 0.1:
                        raise AssertionError(f"bf16 kernel tail {db_k} dB, "
                                             f"default tail {db_x} dB")
                del tail
            log(msg)
            del ydense, y_s2d, got
            torch.cuda.empty_cache()
    del cases, uvp

    def set_tail(tail: str, ydense: bool) -> None:
        pipeline_mod.FUSED_TAIL, pipeline_mod.YDENSE = tail, ydense

    def expect_counts(label, counts, dispatches, want_dispatches, **want):
        want = {k: want.get(k, 0) for k in counts}
        if dispatches != want_dispatches or counts != want:
            raise AssertionError(f"{label}: {dispatches} dispatches, "
                                 f"launches {counts}; want "
                                 f"{want_dispatches}, {want}")

    def expect_equal(label, outs, refs) -> None:
        for k, (got, ref) in enumerate(zip(outs, refs, strict=True)):
            if got.shape != ref.shape or not np.array_equal(got, ref):
                raise AssertionError(f"{label}: frame {k} differs")

    def to_yuv_dev(frames_u8) -> torch.Tensor:
        return _to_yuv(torch.from_numpy(np.stack(frames_u8)).to(dev))

    # 10. the scale stream in its three tails; the last is the main path
    frames64 = list(frames) + list(structured_bgr(rng, 48, 512, 512))
    # untimed: the first pinned host buffers and the allocator's blocks
    list(StreamConverter(fast, batch=16, depth=2, device=dev)
         .process_frames(frames64[:32]))
    seen.clear()
    stream_outs, stream_launches, stream_db = {}, {}, {}
    for kind, tail, ydense in (("scale", "xla", False),
                               ("dense", "xla", True),
                               ("fused_u8", "kernel", False)):
        label = f"phase 10 scale512, W2X_TAIL={tail} W2X_YDENSE={int(ydense)}"
        set_tail(tail, ydense)
        sc = StreamConverter(fast, batch=16, depth=2, device=dev)
        outs, counts, nd = run_stream(sc, frames64, stack, label, smi)
        expect_counts(label, counts, nd, 4, **{kind: 28})
        for k in range(0, 64, 16):   # the batch step on the same batch
            ref = d2s_host_cmajor(scale2x_batch_u8_fused(
                to_yuv_dev(frames64[k:k + 16]), fast).cpu().numpy())
            expect_equal(label + " vs the batch step", outs[k:k + 16], ref)
        db = psnr(np.stack(outs[:2]), ref_main)
        log(f"  in order, equal to the batch step; frames 0-1 vs f32 "
            f"non-kernel path: {db:.2f} dB")
        if outs[0].shape != (1024, 1024, 3) or not db >= PSNR_BAR:
            raise AssertionError(f"{label}: {outs[0].shape}, {db} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        stream_outs[kind], stream_launches[kind] = outs, counts[kind]
        stream_db[kind] = db
    set_tail("xla", False)
    expect_equal("YDENSE stream vs default tail", stream_outs["dense"],
                 stream_outs["scale"])
    # the two round Y at another place: a level at most, at any byte
    worst, frac = check_u8(
        "kernel-tail stream vs default tail",
        torch.from_numpy(np.stack(stream_outs["fused_u8"][:16])),
        torch.from_numpy(np.stack(stream_outs["scale"][:16])), 1, 1.01)
    log(f"phase 10: YDENSE stream == default tail stream bit for bit; "
        f"kernel tail vs default tail (bf16, frames 0-15): {worst} level "
        f"at {frac:.4%} of bytes")
    del stream_outs, outs, ref
    torch.cuda.empty_cache()

    # 11. the noise stream, an odd frame among even ones, the noise_scale
    # stream of from_params, and mixed sizes
    label = "phase 11 noise256"
    sc = StreamConverter(None, batch=256, depth=2, fast_noise=fast_n1,
                         mode="noise", device=dev)
    outs_n, counts, nd = run_stream(
        sc, list(frames_n) + list(frames_n[::-1]), stack, label, smi)
    expect_counts(label, counts, nd, 2, noise=14)
    ref = d2s_host_cmajor(noise_batch_u8_fused(yuv_n, fast_n1).cpu().numpy())
    expect_equal(label + " vs the batch step", outs_n[:256], ref)
    expect_equal(label + " second batch", outs_n[256:], ref[::-1])
    db = psnr(np.stack(outs_n[:2]), ref_n256)
    log(f"  in order, equal to the batch step; frames 0-1 vs f32 "
        f"non-kernel noise_batch: {db:.2f} dB")
    if not db >= PSNR_BAR:
        raise AssertionError(f"{label}: {db} dB")
    hold_seen(seen, stack, f32_twin, max_err)

    label = "phase 11 noise, one odd 255x257 frame among 256x256"
    odd = structured_bgr(rng, 1, 255, 257)[0]
    mix = list(frames_n[:3]) + [odd] + list(frames_n[3:5])
    sc = StreamConverter(None, batch=4, depth=2, fast_noise=fast_n1,
                         mode="noise", device=dev)
    outs, counts, nd = run_stream(sc, mix, stack, label, smi)
    # 4 even frames, the fifth padded to 4, the odd one padded to 4
    expect_counts(label, counts, nd, 3, noise=21)
    expect_equal(label, outs[:3] + outs[4:], outs_n[:5])
    ref_odd = _to_bgr_u8(noise_batch(to_yuv_dev([odd]), modeln32,
                                     cfgn32)).cpu().numpy()[0]
    db = psnr(outs[3], ref_odd)
    log(f"  even frames equal the batch-256 stream's; odd frame "
        f"{outs[3].shape} vs f32 non-kernel noise_batch: {db:.2f} dB")
    if outs[3].shape != odd.shape or not db >= PSNR_BAR:
        raise AssertionError(f"{label}: {outs[3].shape}, {db} dB")
    hold_seen(seen, stack, f32_twin, max_err)
    del outs_n, outs, ref

    label = "phase 11 ns1080, from_params"
    sc = StreamConverter.from_params(
        scale_params=params, noise_params=params_n2, mode="noise_scale",
        batch=8, depth=2, device=dev)
    if (sc._shape_batch(1080, 1920) != 4
            or sc.fast_noise.dtype != torch.float32
            or sc.fast.dtype != torch.bfloat16):
        raise AssertionError(f"{label}: batch "
                             f"{sc._shape_batch(1080, 1920)}, dtypes "
                             f"{sc.fast_noise.dtype} / {sc.fast.dtype}")
    outs, counts, nd = run_stream(sc, list(frames_c) * 2, stack, label, smi)
    expect_counts(label, counts, nd, 2, noise=14, scale=14)
    expect_equal(label + " vs the phase 7 chain", outs, list(out_chain) * 2)
    db_frames = [psnr(o, ref_chain[i % 4]) for i, o in enumerate(outs)]
    log(f"  batch 8 cut to 4 by the volume cap, f32 noise stack; equal to "
        f"the phase 7 chain; frames 0-7 "
        + " / ".join(f"{db:.2f}" for db in db_frames)
        + " dB vs the f32 non-kernel chain")
    if not min(db_frames) >= PSNR_BAR:
        raise AssertionError(f"{label}: {db_frames} dB")
    hold_seen(seen, stack, f32_twin, max_err)
    del outs, out_chain, ref_chain, sc
    torch.cuda.empty_cache()

    label = "phase 11 mixed sizes, W2X_TAIL=kernel"
    sizes = [(360, 640), (270, 480), (512, 512)]
    mixed = [structured_bgr(rng, 1, *sizes[k])[0]
             for k in (0, 1, 0, 2, 1, 0, 0, 2, 1, 0, 2)]
    set_tail("kernel", False)
    sc = StreamConverter(fast, batch=2, depth=2, device=dev)
    outs, counts, nd = run_stream(sc, mixed, stack, label, smi)
    # 5 + 3 + 3 frames at batch 2: 4 full batches and 3 padded tails
    expect_counts(label, counts, nd, 7, fused_u8=49)
    expect_equal(label, outs, [d2s_host_cmajor(scale2x_batch_u8_fused(
        to_yuv_dev([f]), fast).cpu().numpy())[0] for f in mixed])
    log("  output order equals input order; every frame equal to its "
        "single-frame batch step")
    set_tail("xla", False)
    hold_seen(seen, stack, f32_twin, max_err)
    del outs
    restore_wrappers()
    mdir_obj.cleanup()
    log(f"phases 1-11 passed in {time.perf_counter() - t_start:.1f} s")

    # 12. the truncated stack (B7): every upto against its plain version
    def upto_check(y, sp, label) -> float:
        tol = F32_TOL if y.dtype == torch.float32 else BF16_TOL
        errs = []
        for k in range(7):
            stack.reset_launches()
            got = stack.stack_scale_upto(y, sp, k)
            if (stack.LAUNCHES != k + 1 or stack.L6_LAUNCHES["upto"] != 1
                    or stack.KERNEL_LAUNCHES["scale"] != k + 1
                    or tuple(got.shape) != (*y.shape, 4)
                    or got.dtype != y.dtype):
                raise AssertionError(
                    f"upto {k} {label}: {stack.LAUNCHES} launches, "
                    f"{stack.L6_LAUNCHES}, {tuple(got.shape)} {got.dtype}")
            errs.append((got.float() - in_chunks(
                lambda i, j: stack.stack_scale_upto_plain(y[i:j], sp,
                                                          k).float(),
                y, True)).abs().max().item())
            check_max_err(f"upto {k} {label}", errs[-1], tol)
        log(f"phase 12 upto 0..6 {label}: max|kernel - plain| = "
            + " ".join(f"{e:.2e}" for e in errs) + "; upto + 1 launches")
        return max(errs)

    l6_cases = [torch.rand(shape, generator=gen).to(dev)
                for shape in [(2, 37, 53), (1, 5, 300)]]
    max_err["upto"] = 0.0
    for y32 in l6_cases + [ylow]:
        main_shape = y32 is ylow
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sp = ((sp32 if f32 else sp16) if main_shape
                  else (sp_rand if f32 else sp_rand16))
            max_err["upto"] = max(max_err["upto"], upto_check(
                y32.to(dt), sp, f"{tuple(y32.shape)} {dt}"))
    torch.cuda.empty_cache()

    # 13. Winograd layer 6 (B5)
    def plain_kw(name, **kw):
        fn = getattr(stack, name)
        return lambda x, sp: fn(x, sp, **kw)

    def wino_check(y32, sps, label, noise, psnr_gate) -> float:
        """Both dtypes of one input; sps = (f32 weights, bf16 weights)."""
        name = ("stack_noise" if noise and not psnr_gate
                else "stack_noise_s2d" if noise else "stack_scale")
        kernel, plain = getattr(stack, name), plain_kw(name + "_plain",
                                                       l6_wino=True)
        got32 = kernel(y32, sps[0], l6_wino=True)
        ref32 = plain_in_chunks(plain, y32, sps[0], not noise)
        err32 = (got32 - ref32).abs().max().item()
        vs_direct = (got32 - kernel(y32, sps[0], l6_wino=False)
                     ).abs().max().item()
        y16 = y32.to(torch.bfloat16)
        got16 = kernel(y16, sps[1], l6_wino=True).float()
        err16 = (got16 - plain_in_chunks(plain, y16, sps[1], not noise)
                 ).abs().max().item()
        db16 = psnr1(got16, ref32)
        log(f"phase 13 wino {name} {label}: f32 max|kernel - plain| = "
            f"{err32:.3e}, max|wino - direct kernel| = {vs_direct:.3e}; "
            f"bf16 max|kernel - bf16 plain| = {err16:.3e}, bf16 kernel vs "
            f"f32 plain {db16:.2f} dB")
        check_max_err(f"f32 wino {name} {label}", err32, F32_TOL)
        check_max_err(f"f32 wino vs direct {name} {label}", vs_direct,
                      WINO_VS_DIRECT_TOL)
        check_max_err(f"bf16 wino {name} {label}", err16, BF16_TOL)
        if psnr_gate and not db16 >= PSNR_BAR:
            raise AssertionError(f"bf16 wino {name} {label}: {db16} dB")
        return max(err32, err16)

    max_err["wino"] = 0.0
    for y32 in l6_cases:
        for noise in (False, True):
            max_err["wino"] = max(max_err["wino"], wino_check(
                y32, (sp_rand, sp_rand16), tuple(y32.shape), noise, False))
    max_err["wino"] = max(
        max_err["wino"],
        wino_check(ylow, (sp32, sp16), "scale512", False, True),
        wino_check(yn, (spn32, spn16), "noise256", True, True))
    torch.cuda.empty_cache()

    # 14. int8 layer 6 (B4), at equal tile on both sides
    def rms(t: torch.Tensor) -> float:
        return t.double().pow(2).mean().sqrt().item()

    def i8_layer_check(y32, sps, label, tile, noise, frames_a) -> float:
        """(a): layer 6 alone on the kernel's stored layer-5 plane."""
        worst = 0.0
        for sp, dt in zip(sps, (torch.float32, torch.bfloat16)):
            y = y32[:frames_a].to(dt).contiguous()
            x5 = stack.layer5_plane(y, sp, tile, full_res=noise)
            tile_ = tile or stack.default_tile(*(
                (-(-d // 2) for d in y.shape[1:]) if noise else y.shape[1:]))
            x6k, sxk = stack.l6_i8_layer(x5, sp, tile_)
            x6p, sxp = stack.l6_i8_layer_plain(x5, sp, tile_)
            err = (x6k.float() - x6p.float()).abs().max().item()
            log(f"phase 14a i8 layer 6 alone {label} {dt}, tile {tile_}, "
                f"{tuple(sxk.shape)} tiles: max|kernel - plain| = {err:.3e}, "
                f"scales equal: {torch.equal(sxk, sxp)}")
            check_max_err(f"i8 layer 6 {label} {dt}", err,
                          F32_TOL if dt == torch.float32 else BF16_TOL)
            if not torch.equal(sxk, sxp):
                raise AssertionError(f"i8 layer 6 {label} {dt}: the tiles' "
                                     f"scales differ")
            worst = max(worst, err)
            del x5, x6k, x6p
            torch.cuda.empty_cache()
        return worst

    def i8_stack_check(y32, sps, label, tile, noise) -> float:
        """(b): the whole stack, kernel against plain version."""
        name = "stack_noise" if noise else "stack_scale"
        kernel = getattr(stack, name)
        plain = plain_kw(name + "_plain", l6_i8=True, tile=tile)
        got32 = kernel(y32, sps[0], l6_i8=True, tile=tile)
        ref32 = plain_in_chunks(plain, y32, sps[0], not noise)
        cost = ref32 - plain_in_chunks(plain_kw(name + "_plain", l6_i8=False),
                                       y32, sps[0], not noise)
        diff = got32 - ref32
        err32, share = diff.abs().max().item(), (
            diff.abs() > 1e-5).float().mean().item()
        y16 = y32.to(torch.bfloat16)
        got16 = kernel(y16, sps[1], l6_i8=True, tile=tile).float()
        err16 = (got16 - plain_in_chunks(plain, y16, sps[1], not noise)
                 ).abs().max().item()
        log(f"phase 14b i8 {name} {label}, tile {tile}: f32 kernel - plain "
            f"max {err32:.3e} rms {rms(diff):.3e}, {share:.3%} of outputs "
            f"over 1e-5; int8 - direct (plain) max {cost.abs().max().item():.3e} "
            f"rms {rms(cost):.3e}; bf16 max|kernel - bf16 plain| = "
            f"{err16:.3e}, bf16 kernel vs f32 int8 plain "
            f"{psnr1(got16, ref32):.2f} dB")
        if not (err32 <= I8_TIE_MAX * cost.abs().max().item()
                and rms(diff) <= I8_TIE_RMS * rms(cost)
                and share <= I8_TIE_OUTPUTS):
            raise AssertionError(f"f32 i8 {name} {label}: kernel - plain "
                                 f"too far for quantiser ties")
        check_max_err(f"bf16 i8 {name} {label}", err16, BF16_TOL)
        return max(err32, err16)

    max_err["i8_layer"] = max_err["i8"] = 0.0
    one_tile = torch.rand((1, 16, 16), generator=gen).to(dev)
    for y32, tile in ((l6_cases[0], (8, 16)), (l6_cases[1], (8, 16)),
                      (one_tile, None)):
        for noise in (False, True):
            label = (f"{tuple(y32.shape)} "
                     f"{'noise' if noise else 'scale'} input")
            max_err["i8_layer"] = max(max_err["i8_layer"], i8_layer_check(
                y32, (sp_rand, sp_rand16), label, tile, noise, None))
            max_err["i8"] = max(max_err["i8"], i8_stack_check(
                y32, (sp_rand, sp_rand16), label, tile, noise))
    max_err["i8_layer"] = max(
        max_err["i8_layer"],
        i8_layer_check(ylow, (sp32, sp16), "scale512, frames 0-3", None,
                       False, 4),
        i8_layer_check(yn, (spn32, spn16), "noise256, frames 0-63", None,
                       True, 64))
    max_err["i8"] = max(
        max_err["i8"],
        i8_stack_check(ylow, (sp32, sp16), "scale512", None, False),
        i8_stack_check(yn, (spn32, spn16), "noise256", None, True))
    del l6_cases, one_tile
    torch.cuda.empty_cache()

    # 15. the product paths under each layer-6 switch
    from waifu2x_torch.tools import i8_fidelity_probe, layer_time_probe
    from waifu2x_torch.train.qat import l6_quant_gap_db

    def set_l6(form: str) -> None:
        stack.L6_WINO, stack.L6_I8 = form == "wino", form == "i8"

    def expect_l6(label, form, calls, per_call) -> None:
        want = {k: 0 for k in stack.L6_LAUNCHES}
        want[form] = calls * per_call
        if stack.L6_LAUNCHES != want:
            raise AssertionError(f"{label}: layer-6 launches "
                                 f"{stack.L6_LAUNCHES}, want {want}")

    ypad = F.pad(yuv[:2, ..., 0][:, None].cpu(), (7,) * 4,
                 mode="replicate")[:, 0, :256, :256, None].contiguous()
    qat_db = l6_quant_gap_db(params, ypad)
    restore_wrappers = record_wrapper_calls(pipeline_mod, seen)
    l6_launches, l6_db, l6_err = {}, {}, {}
    for form in ("wino", "i8"):
        set_l6(form)
        per_stack = 8 if form == "i8" else 7      # launches per stack call
        per_l6 = 2 if form == "i8" else 1         # of them, layer 6's
        hold_bar = I8_BAR if form == "i8" else PSNR_BAR
        l6_err[form] = {}

        def gate(label, db, db_direct):
            bar = I8_BAR if form == "i8" else db_direct - WINO_DB_SLACK
            log(f"  {label}: frames 0-1 vs f32 non-kernel path {db:.2f} dB "
                f"(direct form {db_direct:.2f} dB; held to {bar:.2f}; the "
                f"product bar is {PSNR_BAR:g})"
                + (f"; QAT proxy of the int8 gap {qat_db:.2f} dB"
                   if form == "i8" else ""))
            if not db >= bar:
                raise AssertionError(f"{label}: {db} dB under {bar}")

        label = f"phase 15 scale512 batch step, layer 6 {form}"
        set_tail("xla", False)
        stack.reset_launches()
        u8 = scale2x_batch_u8_fused(to_yuv_dev(frames), fast)
        out = d2s_host_cmajor(u8.cpu().numpy())
        log(f"{label}: {frames.shape} -> {out.shape}, launches "
            f"{stack.KERNEL_LAUNCHES}, layer 6 {stack.L6_LAUNCHES}")
        if (stack.LAUNCHES != per_stack
                or stack.KERNEL_LAUNCHES["scale"] != per_stack
                or out.shape != (16, 1024, 1024, 3)):
            raise AssertionError(f"{label}: {stack.LAUNCHES} launches, "
                                 f"{out.shape}")
        expect_l6(label, form, 1, per_l6)
        db_step = psnr(out[:2], ref_main)
        gate(label, db_step, db_main)
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        del u8, out

        label = f"phase 15 scale512 stream, W2X_TAIL=kernel, layer 6 {form}"
        set_tail("kernel", False)
        sc = StreamConverter(fast, batch=16, depth=2, device=dev)
        outs, counts, nd = run_stream(sc, frames64, stack, label, smi)
        expect_counts(label, counts, nd, 4, fused_u8=4 * per_stack)
        expect_l6(label, form, 4, per_l6)
        l6_launches[form] = stack.L6_LAUNCHES[form]
        for k in range(0, 64, 16):   # the batch step on the same batch
            ref = d2s_host_cmajor(scale2x_batch_u8_fused(
                to_yuv_dev(frames64[k:k + 16]), fast).cpu().numpy())
            expect_equal(label + " vs the batch step", outs[k:k + 16], ref)
        l6_db[form] = psnr(np.stack(outs[:2]), ref_main)
        log("  in order, equal to the batch step bit for bit")
        gate(label, l6_db[form], stream_db["fused_u8"])
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        set_tail("xla", False)
        del outs, ref

        label = f"phase 15 noise256 batch step, layer 6 {form}"
        stack.reset_launches()
        u8 = noise_batch_u8_fused(yuv_n, fast_n1)
        out = d2s_host_cmajor(u8.cpu().numpy())
        log(f"{label}: {frames_n.shape} -> {out.shape}, launches "
            f"{stack.KERNEL_LAUNCHES}, layer 6 {stack.L6_LAUNCHES}")
        if (stack.KERNEL_LAUNCHES["noise"] != per_stack
                or stack.LAUNCHES != per_stack
                or out.shape != frames_n.shape):
            raise AssertionError(f"{label}: {stack.LAUNCHES} launches, "
                                 f"{out.shape}")
        expect_l6(label, form, 1, per_l6)
        gate(label, psnr(out[:2], ref_n256), db_n256)
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        del u8, out
        torch.cuda.empty_cache()
    set_l6("direct")
    restore_wrappers()

    # the two entry points that drive B7 and B4 directly
    log("phase 15 tools.layer_time_probe (the upto ladder at the scale512 "
        "shape):")
    stack.reset_launches()
    if layer_time_probe.main([]) != 0:
        raise AssertionError("layer_time_probe failed")
    upto_launches = stack.L6_LAUNCHES["upto"]
    # upto 0..6, each once to warm up and --iters (3) times
    if upto_launches != 7 * 4 or stack.L6_LAUNCHES["direct"] != 2 * 4 + 4:
        raise AssertionError(f"layer_time_probe: layer-6 launches "
                             f"{stack.L6_LAUNCHES}")
    log("phase 15 tools.i8_fidelity_probe:")
    stack.reset_launches()
    if (i8_fidelity_probe.main(["--iters", "2"]) != 0
            or not stack.L6_LAUNCHES["i8"] or stack.L6_I8):
        raise AssertionError(f"i8_fidelity_probe: {stack.L6_LAUNCHES}")
    torch.cuda.empty_cache()
    log(f"phases 12-15 passed; {time.perf_counter() - t_start:.1f} s so far")

    maccs = count_maccs_per_pixel()

    # timings, scale512 (CUDA events, after a warm-up)
    yuv16 = _to_yuv(torch.from_numpy(frames).to(dev))
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("xla", True)
    d_step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("kernel", False)
    u_step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("xla", False)
    uvp16 = _uv_phases_cmajor(yuv16)
    kernel_ms = timed_ms(lambda: stack.stack_scale(ylow16, sp16))
    d_kernel_ms = timed_ms(lambda: stack.stack_scale_dense(ylow16, sp16))
    u_kernel_ms = timed_ms(
        lambda: stack.stack_scale_fused_u8(ylow16, uvp16, sp16))
    per_layer = per_layer_ms(
        lambda ev: stack.stack_scale(ylow16, sp16, events=ev), stack)
    d_per_layer = per_layer_ms(
        lambda ev: stack.stack_scale_dense(ylow16, sp16, events=ev), stack)
    u_per_layer = per_layer_ms(
        lambda ev: stack.stack_scale_fused_u8(ylow16, uvp16, sp16, events=ev),
        stack)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the PyTorch pieces around the kernel in each tail
    y_s2d16 = stack.stack_scale(ylow16, sp16)
    ydense16, tc16 = stack.stack_scale_dense(ylow16, sp16)
    tail_ms = timed_ms(lambda: _tail_u8_cmajor(y_s2d16, yuv16))
    unchunk_ms = timed_ms(lambda: stack.dense_to_s2d(
        ydense16, tc16, *ylow16.shape[1:]).contiguous())
    uvp_ms = timed_ms(lambda: _uv_phases_cmajor(yuv16))
    d_io_bytes = ylow16.numel() * 2 + ydense16.numel() * 2
    del y_s2d16, ydense16
    plain_ms = timed_ms(lambda: stack.stack_scale_plain(ylow16, sp16))
    d_plain_ms = timed_ms(
        lambda: stack.stack_scale_dense_plain(ylow16, sp16), reps=2)
    u_plain_ms = timed_ms(
        lambda: stack.stack_scale_fused_u8_plain(ylow16, uvp16, sp16), reps=2)
    torch.cuda.empty_cache()
    xpad16 = F.pad(
        ylow16.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
        (7,) * 4, mode="replicate")[:, 0]
    library_ms = library_stack_ms(xpad16, sp16)
    # one library call sequence for the same function as each new form:
    # the cuDNN bf16 stack, then the chunking / the PyTorch u8 tail
    d_library_ms = library_stack_ms(xpad16, sp16, post=lambda y: (
        stack.s2d_to_dense(s2d(y[..., None]), tc16)))
    u_library_ms = library_stack_ms(xpad16, sp16, post=lambda y: (
        _tail_u8_cmajor(s2d(y[..., None]), yuv16)))
    del xpad16

    n, hl, wl = ylow16.shape
    out_px = n * 4 * hl * wl
    bound_ms, bound_by, flops = stack_bound(ylow16, out_px, sp16, maccs)
    log(f"timing scale512 {n} x {hl}x{wl} -> {2 * hl}x{2 * wl} bf16 on "
        f"{smi}: step {step_ms:.2f} ms = {out_px / step_ms / 1e3:.2f} MP/s; "
        f"kernel {kernel_ms:.2f} ms "
        f"({flops / kernel_ms / 1e9:.2f} TFLOP/s, bound {bound_ms:.2f} ms = "
        f"{100 * bound_ms / kernel_ms:.2f}% of roofline; FFMA floor "
        f"{flops / PEAK_F32_FLOPS * 1e3:.2f} ms); plain {plain_ms:.2f} ms; "
        f"cuDNN bf16 library {library_ms:.2f} ms; "
        f"peak memory {peak_gb:.2f} GB")
    report, act_bytes = layer_rates(per_layer, stack, n, hl, wl, hl * wl)
    log("  per layer: " + report)
    d_bound_ms, d_bound_by, _ = stack_bound(ylow16, out_px, sp16, maccs,
                                            d_io_bytes)
    u_bound_ms, u_bound_by, _ = stack_bound(
        ylow16, out_px, sp16, maccs,
        ylow16.numel() * 2 + uvp16.numel() * 4 + n * hl * wl * 16)
    log(f"timing scale512 tails, bf16, on {smi}: last layer s2d (B1) "
        f"{per_layer[6]:.2f} ms, dense (B6) {d_per_layer[6]:.2f} ms, u8 (B3) "
        f"{u_per_layer[6]:.2f} ms; whole stack s2d {kernel_ms:.2f} ms, dense "
        f"{d_kernel_ms:.2f} ms (bound {d_bound_ms:.2f} ms by {d_bound_by}), "
        f"u8 {u_kernel_ms:.2f} ms (bound {u_bound_ms:.2f} ms by "
        f"{u_bound_by}); step W2X_TAIL=xla {step_ms:.2f} ms, "
        f"W2X_YDENSE=1 {d_step_ms:.2f} ms, W2X_TAIL=kernel "
        f"{u_step_ms:.2f} ms = {out_px / u_step_ms / 1e3:.2f} MP/s; PyTorch "
        f"pieces: u8 tail {tail_ms:.2f} ms, un-chunk {unchunk_ms:.2f} ms, "
        f"uvp build {uvp_ms:.2f} ms; plain dense {d_plain_ms:.2f} ms, u8 "
        f"{u_plain_ms:.2f} ms; cuDNN bf16 library + chunking "
        f"{d_library_ms:.2f} ms, + PyTorch u8 tail {u_library_ms:.2f} ms")
    del uvp16
    log(f"  activation traffic {act_bytes / 1e9:.2f} GB per batch = "
        f"{act_bytes / PEAK_BYTES * 1e3:.2f} ms at {PEAK_BYTES / 1e12} TB/s")
    del yuv16
    torch.cuda.empty_cache()

    # timings, noise256
    torch.cuda.reset_peak_memory_stats()
    n_step_ms = timed_ms(lambda: noise_batch_u8_fused(yuv_n, fast_n1))
    n_kernel_ms = timed_ms(lambda: stack.stack_noise_s2d(yn16, spn16))
    n_per_layer = per_layer_ms(
        lambda ev: stack.stack_noise_s2d(yn16, spn16, events=ev), stack)
    n_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_plain_ms = timed_ms(lambda: stack.stack_noise_s2d_plain(yn16, spn16))
    torch.cuda.empty_cache()
    n_library_ms = library_stack_ms(
        F.pad(yn16[:, None], (7,) * 4, mode="replicate")[:, 0], spn16)
    nn_, hn, wn = yn16.shape
    n_px = nn_ * hn * wn
    n_bound_ms, n_bound_by, n_flops = stack_bound(yn16, n_px, spn16, maccs)
    log(f"timing noise256 {nn_} x {hn}x{wn} bf16 on {smi}: step "
        f"{n_step_ms:.2f} ms = {n_px / n_step_ms / 1e3:.2f} MP/s; kernel "
        f"{n_kernel_ms:.2f} ms ({n_flops / n_kernel_ms / 1e9:.2f} TFLOP/s, "
        f"bound {n_bound_ms:.2f} ms = "
        f"{100 * n_bound_ms / n_kernel_ms:.2f}% of roofline; FFMA floor "
        f"{n_flops / PEAK_F32_FLOPS * 1e3:.2f} ms); plain {n_plain_ms:.2f} "
        f"ms; cuDNN bf16 library {n_library_ms:.2f} ms; peak memory "
        f"{n_peak_gb:.2f} GB")
    report, _ = layer_rates(n_per_layer, stack, nn_, hn // 2, wn // 2,
                            hn * wn)
    log("  per layer: " + report)
    del yuv_n, yn, yn16
    torch.cuda.empty_cache()

    # timings, ns1080 (the bf16 throughput chain and the Converter's f32
    # noise policy), with each stack's kernel alone at its shape
    yc = yuv_c[..., 0].contiguous()
    yc16 = yc.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    c_step = {dt: timed_ms(lambda dt=dt: chain(fast_n2[dt]))
              for dt in (torch.bfloat16, torch.float32)}
    c_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    yc_by_dtype = {torch.bfloat16: yc16, torch.float32: yc}
    c_noise_ms = {dt: timed_ms(lambda dt=dt: stack.stack_noise(
        yc_by_dtype[dt], fast_n2[dt].sp)) for dt in yc_by_dtype}
    c_scale_ms = timed_ms(lambda: stack.stack_scale(yc16, sp16))
    c_per_layer = per_layer_ms(
        lambda ev: stack.stack_noise(yc16, fast_n2[torch.bfloat16].sp,
                                     events=ev), stack)
    c_plain_ms = timed_ms(lambda: stack.stack_noise_plain(
        yc16, fast_n2[torch.bfloat16].sp))
    torch.cuda.empty_cache()
    nc, hc, wc = yc.shape
    c_out_px = nc * 4 * hc * wc
    c_bound = (2 * maccs * nc * hc * wc / PEAK_BF16_FLOPS * 1e3,
               2 * maccs * c_out_px / PEAK_BF16_FLOPS * 1e3)
    log(f"timing ns1080 {nc} x {hc}x{wc} -> {2 * hc}x{2 * wc} on {smi}: "
        f"step bf16/bf16 {c_step[torch.bfloat16]:.2f} ms = "
        f"{c_out_px / c_step[torch.bfloat16] / 1e3:.2f} MP/s; step "
        f"f32/bf16 {c_step[torch.float32]:.2f} ms = "
        f"{c_out_px / c_step[torch.float32] / 1e3:.2f} MP/s; noise kernel "
        f"bf16 {c_noise_ms[torch.bfloat16]:.2f} ms, f32 "
        f"{c_noise_ms[torch.float32]:.2f} ms (bound {c_bound[0]:.2f} ms); "
        f"scale kernel bf16 {c_scale_ms:.2f} ms (bound {c_bound[1]:.2f} ms); "
        f"noise plain bf16 {c_plain_ms:.2f} ms; peak memory "
        f"{c_peak_gb:.2f} GB")
    report, _ = layer_rates(c_per_layer, stack, nc, hc // 2, wc // 2,
                            hc * wc)
    log("  noise per layer (bf16): " + report)

    # timings, layer 6's three forms at scale512 in bf16, beside B1's
    yuv16 = _to_yuv(torch.from_numpy(frames).to(dev))
    l6_t = {}
    for form, kw in (("direct", {}), ("wino", {"l6_wino": True}),
                     ("i8", {"l6_i8": True})):
        set_l6(form)
        l6_t[form] = {
            "stack": timed_ms(lambda: stack.stack_scale(ylow16, sp16, **kw)),
            "layers": per_layer_ms(lambda ev: stack.stack_scale(
                ylow16, sp16, events=ev, **kw), stack),
            "step": timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast)),
        }
        if form != "direct":
            # a few frames at a time: the Winograd plain version keeps
            # more f32 planes alive than the card holds for 16 frames
            l6_t[form]["plain"] = timed_ms(lambda: plain_in_chunks(
                plain_kw("stack_scale_plain", **kw), ylow16, sp16, True),
                reps=1)
            torch.cuda.empty_cache()
    set_l6("direct")
    del yuv16
    maccs_l6 = 128 * 128 * 9
    ops_ms = {   # every layer but 6 at the bf16 peak, layer 6 in its form
        "wino": 2 * out_px * (maccs - maccs_l6 + maccs_l6 * 16 // 36)
        / PEAK_BF16_FLOPS * 1e3,
        "i8": 2 * out_px * ((maccs - maccs_l6) / PEAK_BF16_FLOPS
                            + maccs_l6 / PEAK_INT8_OPS) * 1e3,
    }
    io_ms = (ylow16.numel() * 2 + out_px * 2) / PEAK_BYTES * 1e3
    log(f"timing scale512 layer-6 forms, bf16, on {smi}: "
        + "; ".join(
            f"{form}: stack {t['stack']:.2f} ms, layer 6 "
            f"{t['layers'][5]:.2f} ms, layer 7 {t['layers'][6]:.2f} ms, step "
            f"{t['step']:.2f} ms = {out_px / t['step'] / 1e3:.2f} MP/s"
            + (f", plain (in chunks) {t['plain']:.2f} ms, bound "
               f"{ops_ms[form]:.2f} ms by "
               f"operations (bytes {io_ms:.2f} ms)" if form in ops_ms else "")
            for form, t in l6_t.items())
        + f"; int8 default tile {stack.default_tile(hl, wl)}")

    # timings, the truncated stack (B7) at upto = 6 and its own launches
    u6_ms = timed_ms(lambda: stack.stack_scale_upto(ylow16, sp16, 6))
    u6_plain_ms = timed_ms(lambda: plain_in_chunks(
        lambda x, sp: stack.stack_scale_upto_plain(x, sp, 6), ylow16, sp16,
        True), reps=1)
    torch.cuda.empty_cache()
    own = {}
    for k in (0, 5, 6):   # the last event pair brackets B7's own launch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(k + 2)]
        stack.stack_scale_upto(ylow16, sp16, k)   # the allocator's warm-up
        stack.stack_scale_upto(ylow16, sp16, k, events=ev)
        torch.cuda.synchronize()
        own[k] = ev[k].elapsed_time(ev[k + 1])
    # layers 1-6 and the 9 same-cell taps of 128 channels per s2d cell
    u6_maccs = maccs - 128 * 9 + 128 * 9 // 4
    u6_bound_ms, u6_bound_by, _ = stack_bound(ylow16, out_px, sp16, u6_maccs)
    log(f"timing scale512 stack_scale_upto(6), bf16, on {smi}: "
        f"{u6_ms:.2f} ms (bound {u6_bound_ms:.2f} ms by {u6_bound_by}), "
        f"plain (in chunks) {u6_plain_ms:.2f} ms; B7's own launch: upto 0 "
        f"{own[0]:.3f} ms, upto 5 {own[5]:.3f} ms, upto 6 {own[6]:.3f} ms "
        f"(output {n * hl * wl * 8 / 1e6:.1f} MB)")

    kernels = [{
        "name": "conv3x3_bias_leaky, low-res L1 (stack_scale, B1)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/stack.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": launches,
        "max_abs_err": max_err["stack_scale"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "conv3x3_bias_leaky, full-res L1 (stack_noise_s2d / "
                "stack_noise, B2)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/stack.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": launches_n,
        "max_abs_err": max(max_err["stack_noise"],
                           max_err["stack_noise_s2d"]),
        "ms": n_kernel_ms,
        "plain_ms": n_plain_ms,
        "bound_ms": n_bound_ms,
        "bound_by": n_bound_by,
        "library_ms": n_library_ms,
    }, {
        "name": "conv3x3_bias_leaky_cell, u8 BGR out "
                "(stack_scale_fused_u8, B3)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/stack.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": stream_launches["fused_u8"],
        "max_abs_err": max_err["stack_scale_fused_u8"],
        "max_abs_err_unit": "u8 levels",
        "ms": u_kernel_ms,
        "plain_ms": u_plain_ms,
        "bound_ms": u_bound_ms,
        "bound_by": u_bound_by,
        "library_ms": u_library_ms,
    }, {
        "name": "conv3x3_bias_leaky_cell, dense Y out "
                "(stack_scale_dense, B6)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/stack.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": stream_launches["dense"],
        "max_abs_err": max_err["stack_scale_dense"],
        "ms": d_kernel_ms,
        "plain_ms": d_plain_ms,
        "bound_ms": d_bound_ms,
        "bound_by": d_bound_by,
        "library_ms": d_library_ms,
    }, {
        "name": "upto_gather / conv3x3_bias_leaky_cell taps "
                "(stack_scale_upto, B7)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l6.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": upto_launches,
        "max_abs_err": max_err["upto"],
        "ms": u6_ms,
        "own_launch_ms": {f"upto {k}": own[k] for k in own},
        "plain_ms": u6_plain_ms,
        "bound_ms": u6_bound_ms,
        "bound_by": u6_bound_by,
        "library_ms": None,
    }, {
        "name": "tile_absmax + l6_i8_conv, int8 layer 6 (l6_i8=True, B4)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l6.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": l6_launches["i8"],
        "max_abs_err": max(max_err["i8"], *(
            v for k, v in l6_err["i8"].items()
            if k != "stack_scale_fused_u8")),
        "max_abs_err_layer6_alone": max_err["i8_layer"],
        "ms": l6_t["i8"]["stack"],
        "layer6_ms": l6_t["i8"]["layers"][5],
        "plain_ms": l6_t["i8"]["plain"],
        "bound_ms": max(ops_ms["i8"], io_ms),
        "bound_by": "operations" if ops_ms["i8"] >= io_ms else "bytes",
        "library_ms": library_ms,
        "psnr_db": l6_db["i8"],
    }, {
        "name": "l6_wino, Winograd layer 6 (l6_wino=True, B5)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l6.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": l6_launches["wino"],
        "max_abs_err": max(max_err["wino"], *(
            v for k, v in l6_err["wino"].items()
            if k != "stack_scale_fused_u8")),
        "ms": l6_t["wino"]["stack"],
        "layer6_ms": l6_t["wino"]["layers"][5],
        "plain_ms": l6_t["wino"]["plain"],
        "bound_ms": max(ops_ms["wino"], io_ms),
        "bound_by": "operations" if ops_ms["wino"] >= io_ms else "bytes",
        "library_ms": library_ms,
        "psnr_db": l6_db["wino"],
    }]
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
