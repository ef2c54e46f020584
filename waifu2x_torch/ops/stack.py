"""The scale-path conv stack: the hand-written CUDA kernel's wrapper
(`stack_scale`), its plain PyTorch version (`stack_scale_plain`) and the
device-ready weights they share (`prep_params`).

Contract (that of the JAX package's pallas_stack.stack_scale):

    stack_scale(ylow [N, hl, wl], sp) -> Y_s2d [N, hl, wl, 4] in ylow's dtype
    Y_s2d[n, i, j, A*2+B] = convert_plane(nearest2x(ylow))[n, 2i+A, 2j+B]

Storage is f32 or bf16. Products and sums are f32 (TF32 off); in bf16 each
layer's activation is rounded to bf16 once after its LeakyReLU, and Y once
at the end. The kernel (csrc/stack.cu, which replaces
waifu2x_tpu/ops/pallas_stack.py:_run_stack/_stack_body) launches once per
layer; see the note at the top of that file for its design and bound.

The wrapper takes the plain version for a tensor on the CPU only. For a
CUDA tensor it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waifu2x_torch.ops import _build
from waifu2x_torch.ops.convstack import leaky_relu, no_tf32, pad_replicate
from waifu2x_torch.ops.s2d import s2d

# (cin, cout) of the flagship architecture, the only one the kernel takes
WIDTHS = ((1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
          (128, 1))
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0   # kernel launches (one per layer); the plain version adds none


def prep_params(params, dtype=torch.bfloat16, device="cuda"):
    """HWIO parameters -> the stack's weights: per layer (w [cin, 9, cout]
    in the storage dtype, tap t = dy*3 + dx; b [cout] f32), on `device`."""
    if len(params) != len(WIDTHS):
        raise ValueError(f"the stack takes the {len(WIDTHS)}-layer flagship "
                         f"model, got {len(params)} layers")
    sp = []
    for p, (ci, co) in zip(params, WIDTHS):
        w = torch.as_tensor(p["w"])
        if tuple(w.shape) != (3, 3, ci, co):
            raise ValueError(f"weight shape {tuple(w.shape)} != "
                             f"{(3, 3, ci, co)}")
        w = w.permute(2, 0, 1, 3).reshape(ci, 9, co)
        sp.append((w.to(device, dtype).contiguous(),
                   torch.as_tensor(p["b"]).to(device, torch.float32)))
    return tuple(sp)


def _check(ylow: torch.Tensor, sp) -> None:
    if ylow.dim() != 3 or min(ylow.shape) < 1:
        raise ValueError(f"ylow must be a non-empty [N, hl, wl] plane, got "
                         f"shape {tuple(ylow.shape)}")
    if ylow.dtype not in DTYPES:
        raise TypeError(f"ylow must be float32 or bfloat16, got {ylow.dtype}")
    if not ylow.is_contiguous():
        raise ValueError("ylow must be contiguous")
    if len(sp) != len(WIDTHS):
        raise ValueError(f"expected {len(WIDTHS)} layers, got {len(sp)}")
    for k, ((w, b), (ci, co)) in enumerate(zip(sp, WIDTHS)):
        if tuple(w.shape) != (ci, 9, co) or tuple(b.shape) != (co,):
            raise ValueError(f"layer {k}: weights {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, want {(ci, 9, co)} / {(co,)}")
        if w.dtype != ylow.dtype or b.dtype != torch.float32:
            raise TypeError(f"layer {k}: weights must be {ylow.dtype} and "
                            f"bias float32, got {w.dtype} / {b.dtype}")
        if w.device != ylow.device or b.device != ylow.device:
            raise ValueError(f"layer {k}: weights on {w.device}, ylow on "
                             f"{ylow.device}")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"layer {k}: weights must be contiguous")


def stack_scale_plain(ylow: torch.Tensor, sp) -> torch.Tensor:
    """Plain PyTorch version of the kernel: nearest-2x, replicate pad 7,
    7 x (F.conv2d + bias + LeakyReLU) in f32 with TF32 off, rounding each
    stored activation to ylow's dtype where the kernel does, then s2d."""
    _check(ylow, sp)
    dtype = ylow.dtype
    up = ylow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    x = pad_replicate(up.float(), 7)                  # [N, 1, 2hl+14, 2wl+14]
    with no_tf32():
        for w, b in sp:
            ci, _, co = w.shape
            w_oihw = w.float().reshape(ci, 3, 3, co).permute(3, 0, 1, 2)
            x = leaky_relu(F.conv2d(x, w_oihw, b)).to(dtype).float()
    return s2d(x[:, 0, :, :, None]).to(dtype)


def _lib() -> ctypes.CDLL:
    (lib,) = _build.load("stack")
    lib.w2x_stack_layer.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.w2x_stack_layer.restype = ctypes.c_int
    lib.w2x_error_string.argtypes = [ctypes.c_int]
    lib.w2x_error_string.restype = ctypes.c_char_p
    return lib


def stack_scale(ylow: torch.Tensor, sp, events=None) -> torch.Tensor:
    """ylow [N, hl, wl] (f32 or bf16, contiguous) -> Y_s2d [N, hl, wl, 4].
    CPU tensors take the plain version; CUDA tensors take the kernel: 7
    launches on the current stream, no synchronisation. `events`, a list
    of 8 timing-enabled CUDA events, is recorded before the first launch
    and after each, for per-layer times."""
    global LAUNCHES
    _check(ylow, sp)
    if ylow.device.type == "cpu":
        return stack_scale_plain(ylow, sp)
    if ylow.device.type != "cuda":
        raise ValueError(f"no kernel for device {ylow.device}")
    lib = _lib()
    n, hl, wl = ylow.shape
    act = n * (2 * hl + 12) * (2 * wl + 12) * 128   # layer 1-6 outputs fit
    with torch.cuda.device(ylow.device):
        bufs = [torch.empty(act, dtype=ylow.dtype, device=ylow.device)
                for _ in range(2)]
        out = torch.empty((n, hl, wl, 4), dtype=ylow.dtype,
                          device=ylow.device)
        stream = torch.cuda.current_stream(ylow.device).cuda_stream
        src = ylow
        if events is not None:
            events[0].record()
        for k, (w, b) in enumerate(sp):
            dst = out if k == len(sp) - 1 else bufs[k % 2]
            err = lib.w2x_stack_layer(
                int(ylow.dtype == torch.bfloat16), k, src.data_ptr(),
                w.data_ptr(), b.data_ptr(), dst.data_ptr(), n, hl, wl,
                stream)
            if err:
                raise RuntimeError(f"stack kernel, layer {k + 1}: "
                                   f"{lib.w2x_error_string(err).decode()}")
            LAUNCHES += 1
            if events is not None:
                events[k + 1].record()
            src = dst
    return out
