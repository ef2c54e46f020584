"""The conv stack's hand-written CUDA kernel: its wrappers for the scale
path (`stack_scale`) and the noise path (`stack_noise_s2d`, `stack_noise`),
their plain PyTorch versions (`*_plain`) and the device-ready weights they
share (`prep_params`; one layout serves both paths).

Contracts (those of the JAX package's pallas_stack functions of the same
names):

    stack_scale(ylow [N, hl, wl], sp) -> Y_s2d [N, hl, wl, 4]
        Y_s2d[n, i, j, A*2+B] = convert_plane(nearest2x(ylow))[n, 2i+A, 2j+B]
    stack_noise_s2d(y [N, h, w], sp) -> Y_s2d [N, h/2, w/2, 4]  (h, w even)
        Y_s2d[n, i, j, A*2+B] = convert_plane(y)[n, 2i+A, 2j+B]
    stack_noise(y [N, h, w], sp) -> [N, h, w]  (any h, w)
        convert_plane of y edge-padded to even, cropped back to h x w

all in the input's dtype. Storage is f32 or bf16. Products and sums are f32
(TF32 off); in bf16 each layer's activation is rounded to bf16 once after
its LeakyReLU, and Y once at the end. The kernel (csrc/stack.cu, which
replaces waifu2x_tpu/ops/pallas_stack.py:_run_stack/_stack_body) launches
once per layer; see the note at the top of that file for its design and
bound.

The wrappers take the plain version for a tensor on the CPU only. For a
CUDA tensor they launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waifu2x_torch.ops import _build
from waifu2x_torch.ops.convstack import leaky_relu, no_tf32, pad_replicate
from waifu2x_torch.ops.s2d import d2s, s2d

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
        raise ValueError(f"the input must be a non-empty [N, h, w] plane, "
                         f"got shape {tuple(ylow.shape)}")
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


def _check_even(y: torch.Tensor, fn: str) -> None:
    h, w = y.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"{fn} needs even dims, got {h}x{w}")


def _plain_stack(x: torch.Tensor, sp, dtype) -> torch.Tensor:
    """7 x (F.conv2d + bias + LeakyReLU) on the padded f32 plane x
    [N, 1, H, W], f32 with TF32 off, each stored activation rounded to
    `dtype` where the kernel rounds it -> [N, 1, H-14, W-14] (f32 values)."""
    with no_tf32():
        for w, b in sp:
            ci, _, co = w.shape
            w_oihw = w.float().reshape(ci, 3, 3, co).permute(3, 0, 1, 2)
            x = leaky_relu(F.conv2d(x, w_oihw, b)).to(dtype).float()
    return x


def stack_scale_plain(ylow: torch.Tensor, sp) -> torch.Tensor:
    """Plain PyTorch version of the scale kernel: nearest-2x, replicate pad
    7, the stack (_plain_stack), then s2d."""
    _check(ylow, sp)
    up = ylow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    x = _plain_stack(pad_replicate(up.float(), 7), sp, ylow.dtype)
    return s2d(x[:, 0, :, :, None]).to(ylow.dtype)


def _noise_plain_s2d(y: torch.Tensor, sp) -> torch.Tensor:
    """Plain noise stack on any [N, h, w]: edge pad to even and replicate
    pad 7 (one replicate pad does both), the stack, then s2d ->
    [N, he/2, we/2, 4]."""
    _check(y, sp)
    h, w = y.shape[1:]
    x = F.pad(y.float()[:, None], (7, 7 + w % 2, 7, 7 + h % 2),
              mode="replicate")
    x = _plain_stack(x, sp, y.dtype)
    return s2d(x[:, 0, :, :, None]).to(y.dtype)


def stack_noise_s2d_plain(y: torch.Tensor, sp) -> torch.Tensor:
    """Plain PyTorch version of stack_noise_s2d (even dims only)."""
    _check_even(y, "stack_noise_s2d")
    return _noise_plain_s2d(y, sp)


def stack_noise_plain(y: torch.Tensor, sp) -> torch.Tensor:
    """Plain PyTorch version of stack_noise (any dims)."""
    ys = _noise_plain_s2d(y, sp)
    h, w = y.shape[1:]
    return d2s(ys)[:, :h, :w, 0]


def _lib() -> ctypes.CDLL:
    (lib,) = _build.load("stack")
    lib.w2x_stack_layer.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.w2x_stack_layer.restype = ctypes.c_int
    lib.w2x_error_string.argtypes = [ctypes.c_int]
    lib.w2x_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, sp, full_res: bool, events) -> torch.Tensor:
    """The kernel's 7 launches on the current stream, no synchronisation:
    x is the low-res plane [N, hl, wl] (scale) or the full-res plane
    [N, h, w] (noise, any size, computed on the even-rounded plane) ->
    Y_s2d [N, hl, wl, 4] with hl = ceil(h/2) on the noise path. `events`,
    a list of 8 timing-enabled CUDA events, is recorded before the first
    launch and after each, for per-layer times."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _lib()
    n, ph, pw = x.shape
    hl, wl = ((ph + 1) // 2, (pw + 1) // 2) if full_res else (ph, pw)
    act = n * (2 * hl + 12) * (2 * wl + 12) * 128   # layer 1-6 outputs fit
    with torch.cuda.device(x.device):
        bufs = [torch.empty(act, dtype=x.dtype, device=x.device)
                for _ in range(2)]
        out = torch.empty((n, hl, wl, 4), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        src = x
        if events is not None:
            events[0].record()
        for k, (w, b) in enumerate(sp):
            dst = out if k == len(sp) - 1 else bufs[k % 2]
            err = lib.w2x_stack_layer(
                int(x.dtype == torch.bfloat16), int(full_res), k,
                src.data_ptr(), w.data_ptr(), b.data_ptr(), dst.data_ptr(),
                n, ph, pw, stream)
            if err:
                raise RuntimeError(f"stack kernel, layer {k + 1}: "
                                   f"{lib.w2x_error_string(err).decode()}")
            LAUNCHES += 1
            if events is not None:
                events[k + 1].record()
            src = dst
    return out


def stack_scale(ylow: torch.Tensor, sp, events=None) -> torch.Tensor:
    """ylow [N, hl, wl] (f32 or bf16, contiguous) -> Y_s2d [N, hl, wl, 4].
    CPU tensors take the plain version; CUDA tensors take the kernel (see
    _launch for `events`)."""
    _check(ylow, sp)
    if ylow.device.type == "cpu":
        return stack_scale_plain(ylow, sp)
    return _launch(ylow, sp, False, events)


def stack_noise_s2d(y: torch.Tensor, sp, events=None) -> torch.Tensor:
    """y [N, h, w] (h, w even; f32 or bf16, contiguous) -> Y_s2d
    [N, h/2, w/2, 4]; raises on odd dims (stack_noise takes any size).
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    _check(y, sp)
    _check_even(y, "stack_noise_s2d")
    if y.device.type == "cpu":
        return stack_noise_s2d_plain(y, sp)
    return _launch(y, sp, True, events)


def stack_noise(y: torch.Tensor, sp, events=None) -> torch.Tensor:
    """y [N, h, w] (any h, w) -> the denoised plane [N, h, w]: the kernel
    runs on the plane edge-padded to even (in its layer-1 index map) and
    the s2d result is interleaved (d2s) and cropped. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    _check(y, sp)
    if y.device.type == "cpu":
        return stack_noise_plain(y, sp)
    h, w = y.shape[1:]
    return d2s(_launch(y, sp, True, events))[:, :h, :w, 0]
