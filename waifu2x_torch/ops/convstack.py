"""The 7-layer conv stack over `F.conv2d` — the port's f32 reference and its
non-kernel path (reference-exact semantics).

Semantics (the reference's, as the JAX package has them):
  * correlation, not convolution — cv::filter2D does NOT flip the kernel
    (modelHandler.cpp:141-142); `F.conv2d` is correlation too, so weights
    pass through unflipped. HWIO parameters map to OIHW by a transpose.
  * bias add then LeakyReLU(0.1) after EVERY layer including the last
    (modelHandler.cpp:147-152).
  * border handling: replicate-pad the input plane by the model offset (7)
    and run VALID convolutions; the cropped interior of the reference's
    same-size replicate scheme equals this (convertRoutine.cpp:35-46).
  * full f32: cuDNN runs f32 convolutions in TF32 unless told otherwise,
    so every convolution here runs under a local TF32-off context
    (`no_tf32`), never a global switch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.1  # reference: modelHandler.cpp:152 (scaleAdd 0.1)


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """max(x,0) + slope*min(x,0) — exact form of modelHandler.cpp:148-152."""
    return torch.clamp(x, min=0) + slope * torch.clamp(x, max=0)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full f32 (TF32 off) inside this block only."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def conv_stack_nchw(x: torch.Tensor, layers) -> torch.Tensor:
    """VALID conv stack on NCHW input; layers = [(w_oihw, b), ...]."""
    with no_tf32():
        for w, b in layers:
            x = leaky_relu(F.conv2d(x, w.to(x.dtype), b.to(x.dtype)))
    return x


def conv_stack_valid(x: torch.Tensor, params) -> torch.Tensor:
    """Run the full conv stack with VALID padding.

    x: [N, H, W, 1] input luma planes (NHWC, as the JAX package's API),
       already edge-padded by the model offset.
    params: tuple of {"w": [kh,kw,cin,cout], "b": [cout]} tensors.
    Returns [N, H - 2*offset, W - 2*offset, 1].
    """
    layers = [(hwio_to_oihw(p["w"]), p["b"]) for p in params]
    out = conv_stack_nchw(x.permute(0, 3, 1, 2), layers)
    return out.permute(0, 2, 3, 1)


def pad_replicate(y: torch.Tensor, offset: int) -> torch.Tensor:
    """[N, H, W] -> [N, 1, H + 2*offset, W + 2*offset], edge-replicated."""
    return F.pad(y[:, None], (offset,) * 4, mode="replicate")


def convert_plane(y: torch.Tensor, params) -> torch.Tensor:
    """Monolithic plane conversion: replicate-pad by the model offset, run
    the stack, return a same-size plane (convertRoutine.cpp:31-48).
    y: [H, W] or [N, H, W]."""
    offset = sum(int(p["w"].shape[0]) // 2 for p in params)
    squeeze_batch = y.dim() == 2
    if squeeze_batch:
        y = y[None]
    layers = [(hwio_to_oihw(p["w"]), p["b"]) for p in params]
    out = conv_stack_nchw(pad_replicate(y, offset), layers)[:, 0]
    return out[0] if squeeze_batch else out
