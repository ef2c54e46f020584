"""The conv stack's hand-written CUDA kernel: its wrappers for the scale
path (`stack_scale`, and the last layer's two other output forms
`stack_scale_dense` and `stack_scale_fused_u8`) and the noise path
(`stack_noise_s2d`, `stack_noise`), their plain PyTorch versions
(`*_plain`) and the device-ready weights they share (`prep_params`; one
layout serves both paths).

Contracts (those of the JAX package's pallas_stack functions of the same
names):

    stack_scale(ylow [N, hl, wl], sp) -> Y_s2d [N, hl, wl, 4]
        Y_s2d[n, i, j, A*2+B] = convert_plane(nearest2x(ylow))[n, 2i+A, 2j+B]
    stack_scale_dense(ylow, sp, tc) -> (ydense [N, hl, nx*4*tc], tc)
        ydense[n, i, j*4tc + q*tc + c] = Y_s2d[n, i, j*tc + c, q], with
        nx = ceil(wl / tc) and zeros past wl; dense_to_s2d undoes it
    stack_scale_fused_u8(ylow, uvp [N, hl, wl, 8] f32, sp) -> u8 BGR
        [N, hl, wl, 16], lane c*4 + phase, lanes 12:16 zero: the YUV -> BGR
        map and the saturating cast of ops/color.py on the f32 Y (never
        rounded to the storage dtype) and the polyphase U/V (u phases 0:4,
        v phases 4:8)
    stack_noise_s2d(y [N, h, w], sp) -> Y_s2d [N, h/2, w/2, 4]  (h, w even)
        Y_s2d[n, i, j, A*2+B] = convert_plane(y)[n, 2i+A, 2j+B]
    stack_noise(y [N, h, w], sp) -> [N, h, w]  (any h, w)
        convert_plane of y edge-padded to even, cropped back to h x w

in the input's dtype where not said otherwise. Storage is f32 or bf16.
Products and sums are f32 (TF32 off); in bf16 each layer's activation is
rounded to bf16 once after its LeakyReLU, and Y once at the end (not at
all on its way into the u8 map). The kernel (csrc/stack.cu, which replaces
waifu2x_tpu/ops/pallas_stack.py:_run_stack/_stack_body) launches once per
layer, 7 times per call in every output form; see the note at the top of
that file for its design and bound.

The wrappers take the plain version for a tensor on the CPU only. For a
CUDA tensor they launch the kernel or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waifu2x_torch.ops import _build, color
from waifu2x_torch.ops.convstack import leaky_relu, no_tf32, pad_replicate
from waifu2x_torch.ops.s2d import d2s, s2d

# (cin, cout) of the flagship architecture, the only one the kernel takes
WIDTHS = ((1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
          (128, 1))
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0   # kernel launches (one per layer); the plain version adds none
# the same launches by the kernel configuration that made them: "scale"
# (stack_scale), "noise" (stack_noise, stack_noise_s2d), "dense"
# (stack_scale_dense), "fused_u8" (stack_scale_fused_u8)
KERNEL_LAUNCHES = {"scale": 0, "noise": 0, "dense": 0, "fused_u8": 0}

# the last layer's output forms (csrc/stack.cu: OUT_*)
_OUT_S2D, _OUT_DENSE, _OUT_U8 = 0, 1, 2
DENSE_TC = 128   # widest dense chunk: four warps' contiguous stores per phase


def reset_launches() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for kind in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[kind] = 0


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


def _check_uvp(uvp: torch.Tensor, ylow: torch.Tensor) -> None:
    if tuple(uvp.shape) != (*ylow.shape, 8):
        raise ValueError(f"uvp must be {(*ylow.shape, 8)} for ylow "
                         f"{tuple(ylow.shape)}, got {tuple(uvp.shape)}")
    if uvp.dtype != torch.float32:
        raise TypeError(f"uvp must be float32, got {uvp.dtype}")
    if uvp.device != ylow.device:
        raise ValueError(f"uvp on {uvp.device}, ylow on {ylow.device}")
    if not uvp.is_contiguous():
        raise ValueError("uvp must be contiguous")


def _dense_tc(wl: int, tc) -> int:
    """The dense chunk width: the caller's, or the low-res width rounded up
    to a warp's 32 columns, at most DENSE_TC."""
    if tc is None:
        return min(DENSE_TC, 32 * -(-wl // 32))
    if tc <= 0 or tc % 32:
        raise ValueError(f"tc must be a positive multiple of 32, got {tc}")
    return tc


def _plain_stack(x: torch.Tensor, sp, dtype,
                 round_last: bool = True) -> torch.Tensor:
    """7 x (F.conv2d + bias + LeakyReLU) on the padded f32 plane x
    [N, 1, H, W], f32 with TF32 off, each stored activation rounded to
    `dtype` where the kernel rounds it -> [N, 1, H-14, W-14] (f32 values).
    round_last=False leaves the last layer's output unrounded, as the u8
    epilogue reads it."""
    with no_tf32():
        for k, (w, b) in enumerate(sp):
            ci, _, co = w.shape
            w_oihw = w.float().reshape(ci, 3, 3, co).permute(3, 0, 1, 2)
            x = leaky_relu(F.conv2d(x, w_oihw, b))
            if round_last or k < len(sp) - 1:
                x = x.to(dtype).float()
    return x


def _scale_plain_f32(ylow: torch.Tensor, sp, round_last: bool = True):
    """nearest-2x, replicate pad 7, the stack (_plain_stack), then s2d ->
    Y_s2d [N, hl, wl, 4] as f32 values."""
    up = ylow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    x = _plain_stack(pad_replicate(up.float(), 7), sp, ylow.dtype, round_last)
    return s2d(x[:, 0, :, :, None])


def stack_scale_plain(ylow: torch.Tensor, sp) -> torch.Tensor:
    """Plain PyTorch version of the scale kernel."""
    _check(ylow, sp)
    return _scale_plain_f32(ylow, sp).to(ylow.dtype)


def s2d_to_dense(y_s2d: torch.Tensor, tc: int) -> torch.Tensor:
    """Y_s2d [N, hl, wl, 4] -> the phase-chunked dense layout
    [N, hl, nx*4*tc] (zeros past wl); the inverse of dense_to_s2d."""
    n, hl, wl, _ = y_s2d.shape
    nx = -(-wl // tc)
    y = F.pad(y_s2d, (0, 0, 0, nx * tc - wl))
    return (y.reshape(n, hl, nx, tc, 4).transpose(3, 4)
            .reshape(n, hl, nx * 4 * tc))


def dense_to_s2d(ydense: torch.Tensor, tc: int, hl: int,
                 wl: int) -> torch.Tensor:
    """Un-chunk stack_scale_dense's output to the s2d layout
    [N, hl, wl, 4]: a reshape, a transpose and a crop."""
    n, hp, wd = ydense.shape
    nx = wd // (4 * tc)
    y4 = (ydense.reshape(n, hp, nx, 4, tc).transpose(3, 4)
          .reshape(n, hp, nx * tc, 4))
    return y4[:, :hl, :wl, :]


def stack_scale_dense_plain(ylow: torch.Tensor, sp, tc=None):
    """Plain PyTorch version of stack_scale_dense -> (ydense, tc)."""
    _check(ylow, sp)
    tc = _dense_tc(ylow.shape[2], tc)
    return s2d_to_dense(stack_scale_plain(ylow, sp), tc), tc


def combine_u8_cmajor(y: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> list:
    """f32 Y/U/V planes of one shape -> [B, G, R] uint8 planes of that
    shape: yuv_to_bgr and saturate_cast_u8 of ops/color.py, elementwise in
    the f32 order ((y*inv[c,0] + u*inv[c,1]) + v*inv[c,2]) + off[c], then
    * 255, round half to even, clamp to 0..255."""
    inv, off = color._INV, color._INV_OFF
    chans = []
    for c in range(3):
        val = (y * float(inv[c, 0]) + u * float(inv[c, 1])
               + v * float(inv[c, 2]) + float(off[c])) * 255.0
        chans.append(torch.clamp(torch.round(val), 0, 255).to(torch.uint8))
    return chans


def stack_scale_fused_u8_plain(ylow: torch.Tensor, uvp: torch.Tensor,
                               sp) -> torch.Tensor:
    """Plain PyTorch version of stack_scale_fused_u8: the stack with its
    last layer left in f32, then the colour map on Y and uvp."""
    _check(ylow, sp)
    _check_uvp(uvp, ylow)
    y = _scale_plain_f32(ylow, sp, round_last=False)
    chans = combine_u8_cmajor(y, uvp[..., 0:4], uvp[..., 4:8])
    return torch.cat(chans + [torch.zeros_like(chans[0])], dim=-1)


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
    lib.w2x_stack_layer.restype = ctypes.c_int
    lib.w2x_error_string.argtypes = [ctypes.c_int]
    lib.w2x_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, sp, kind: str, events, uvp=None,
            tc: int = 0) -> torch.Tensor:
    """The kernel's 7 launches on the current stream, no synchronisation:
    x is the low-res plane [N, hl, wl] (kinds "scale", "dense",
    "fused_u8") or the full-res plane [N, h, w] ("noise": any size,
    computed on the even-rounded plane, hl = ceil(h/2)). The last layer
    writes Y_s2d [N, hl, wl, 4], or for "dense" Y [N, hl, nx*4*tc], or for
    "fused_u8" u8 BGR [N, hl, wl, 16] from `uvp`. `events`, a list of 8
    timing-enabled CUDA events, is recorded before the first launch and
    after each, for per-layer times."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _lib()
    full_res = kind == "noise"
    n, ph, pw = x.shape
    hl, wl = ((ph + 1) // 2, (pw + 1) // 2) if full_res else (ph, pw)
    act = n * (2 * hl + 12) * (2 * wl + 12) * 128   # layer 1-6 outputs fit
    out_mode, cmap = _OUT_S2D, None
    with torch.cuda.device(x.device):
        bufs = [torch.empty(act, dtype=x.dtype, device=x.device)
                for _ in range(2)]
        # every element of each output form is written by the last launch
        if kind == "dense":
            out_mode = _OUT_DENSE
            out = torch.empty((n, hl, -(-wl // tc) * 4 * tc), dtype=x.dtype,
                              device=x.device)
        elif kind == "fused_u8":
            out_mode = _OUT_U8
            cmap = (ctypes.c_float * 12)(*color._INV.ravel().tolist(),
                                         *color._INV_OFF.tolist())
            out = torch.empty((n, hl, wl, 16), dtype=torch.uint8,
                              device=x.device)
        else:
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
                n, ph, pw, out_mode,
                None if uvp is None else uvp.data_ptr(), cmap, tc, stream)
            if err:
                raise RuntimeError(f"stack kernel, layer {k + 1}: "
                                   f"{lib.w2x_error_string(err).decode()}")
            LAUNCHES += 1
            KERNEL_LAUNCHES[kind] += 1
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
    return _launch(ylow, sp, "scale", events)


def stack_scale_dense(ylow: torch.Tensor, sp, tc=None, events=None):
    """ylow [N, hl, wl] -> (ydense [N, hl, nx*4*tc], tc): stack_scale's Y
    with the last layer storing it phase-chunked and dense (zeros past wl
    in the last chunk); dense_to_s2d(ydense, tc, hl, wl) gives stack_scale's
    output bit for bit. tc, a multiple of 32, defaults to the low-res
    width rounded up to 32, at most DENSE_TC. CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    _check(ylow, sp)
    tc = _dense_tc(ylow.shape[2], tc)
    if ylow.device.type == "cpu":
        return stack_scale_dense_plain(ylow, sp, tc)
    return _launch(ylow, sp, "dense", events, tc=tc), tc


def stack_scale_fused_u8(ylow: torch.Tensor, uvp: torch.Tensor, sp,
                         events=None) -> torch.Tensor:
    """ylow [N, hl, wl] + channel-major polyphase U/V uvp [N, hl, wl, 8]
    (f32, contiguous; u phases 0:4, v phases 4:8) -> u8 BGR
    [N, hl, wl, 16], lane c*4 + phase, lanes 12:16 zero: the whole 2x step's
    output, with the last layer's f32 Y going straight into the colour map.
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    _check(ylow, sp)
    _check_uvp(uvp, ylow)
    if ylow.device.type == "cpu":
        return stack_scale_fused_u8_plain(ylow, uvp, sp)
    return _launch(ylow, sp, "fused_u8", events, uvp=uvp)


def stack_noise_s2d(y: torch.Tensor, sp, events=None) -> torch.Tensor:
    """y [N, h, w] (h, w even; f32 or bf16, contiguous) -> Y_s2d
    [N, h/2, w/2, 4]; raises on odd dims (stack_noise takes any size).
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    _check(y, sp)
    _check_even(y, "stack_noise_s2d")
    if y.device.type == "cpu":
        return stack_noise_s2d_plain(y, sp)
    return _launch(y, sp, "noise", events)


def stack_noise(y: torch.Tensor, sp, events=None) -> torch.Tensor:
    """y [N, h, w] (any h, w) -> the denoised plane [N, h, w]: the kernel
    runs on the plane edge-padded to even (in its layer-1 index map) and
    the s2d result is interleaved (d2s) and cropped. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    _check(y, sp)
    if y.device.type == "cpu":
        return stack_noise_plain(y, sp)
    h, w = y.shape[1:]
    return d2s(_launch(y, sp, "noise", events))[:, :h, :w, 0]
