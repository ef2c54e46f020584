"""Multi-device kernel path, one step at a time, over a ("dp", "sp") mesh
(the counterpart of the JAX package's parallel/fast_sharded.py): frames
split over "dp", image width over "sp", halos exchanged once per step
(mesh.halo), and the hand-written conv-stack kernels (ops/stack.py through
pipeline.FastStack) run on each position's shard, each position with the
stack's weights on its own device.

Why a 4-column halo suffices for the 2x step: it runs on the LOW-RES grid
(s2d), where the 7-layer stack's receptive radius is 7 full-res px = 4
low-res px (and the polyphase bicubic needs 2). Each shard grows by 4
columns from its neighbours (replicate at the true image edges, exactly
BORDER_REPLICATE), runs the unchanged kernels, and drops 4 columns again:
interior pixels see the inputs of the monolithic pass, so the outputs are
the single-device ones (tests/test_torch_fast_sharded.py).
"""

from __future__ import annotations

import torch

from waifu2x_torch.ops.color import saturate_cast_u8, yuv_to_bgr
from waifu2x_torch.ops.resize import CUBIC, resize2x_phases
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.pipeline import FastStack

HALO = 4  # low-res columns: ceil(7 / 2) for the stack, >= 2 for bicubic
NOISE_HALO = 8   # full-res columns: the stack's receptive radius is 7; 8
#                  keeps every shard's extended width even (s2d needs even
#                  dims)

_YUV = ("dp", None, "sp", None)
_PLANE = ("dp", None, "sp")


def _halo_cols(x: m.Sharded, k: int, axis_name: str) -> m.Sharded:
    """Attach k halo columns (dim 2 of [n, h, w, ...]) from the mesh
    neighbours along axis_name; replicate the own edge columns at the true
    image borders."""
    if x.mesh.axis_size(axis_name) > 1 and x.block_shape[2] < k:
        raise ValueError(
            f"width shard ({x.block_shape[2]} cols) narrower than the {k}-col "
            f"halo — use fewer 'sp' devices for this image width")
    return m.halo(x, k, axis_name, 2)


def make_mesh(shape: "tuple[int, int] | None" = None,
              devices=None) -> m.Mesh:
    """A ("dp", "sp") mesh (frames data-parallel x width sharding) over
    `devices` (default: every card)."""
    if devices is None:
        devices = m.local_devices()
    if shape is None:
        shape = (1, len(devices))
    return m.make_mesh(shape, ("dp", "sp"), devices)


def _placed(x, mesh: m.Mesh, spec) -> m.Sharded:
    return x if isinstance(x, m.Sharded) else m.shard(x, mesh, spec)


def scale2x_u8_s2d_sharded(yuv, fast: FastStack, mesh: m.Mesh) -> m.Sharded:
    """Sharded twin of pipeline.scale2x_batch_u8_s2d: f32 YUV [N, hl, wl, 3]
    (a tensor, or already sharded ("dp", None, "sp", None)) -> u8 BGR in
    the polyphase layout [N, hl, wl, 12], sharded the same way. Needs
    N % dp == 0 and wl % sp == 0 (pad with pad_width_to_mesh first)."""
    stacks = m.replicate(fast, mesh)

    def local(ext: torch.Tensor) -> torch.Tensor:
        y_s2d = stacks[ext.device].scale(ext[..., 0])
        y_s2d = y_s2d[:, :, HALO:-HALO, :].to(ext.dtype)
        uv = resize2x_phases(ext[..., 1:3], CUBIC, h_axis=1)
        uv = uv.transpose(-1, -2)[:, :, HALO:-HALO]      # [nl,hl,wloc,4,2]
        out = torch.cat([y_s2d[..., None], uv], dim=-1)
        u8 = saturate_cast_u8(yuv_to_bgr(out))
        nl, h, w = u8.shape[:3]
        return u8.reshape(nl, h, w, 12)

    return m.shard_map(local, _halo_cols(_placed(yuv, mesh, _YUV), HALO,
                                         "sp"))


def noise_plane_sharded(y, fast: FastStack, mesh: m.Mesh) -> m.Sharded:
    """Sharded twin of FastStack.noise: f32 Y planes [N, h, w] (a tensor, or
    sharded ("dp", None, "sp")) -> the same shape, sharded the same way.
    The noise path runs at FULL resolution, so the halo is 8 full-res
    columns. Needs N % dp == 0 and every width shard even (noise_batch_on_mesh
    takes any width). The kernel's s2d phases do not depend on the plane's
    offset, so interior pixels match the monolithic pass."""
    stacks = m.replicate(fast, mesh)

    def local(ext: torch.Tensor) -> torch.Tensor:
        out = stacks[ext.device].noise(ext)
        return out[:, :, NOISE_HALO:-NOISE_HALO].to(ext.dtype)

    return m.shard_map(local, _halo_cols(_placed(y, mesh, _PLANE),
                                         NOISE_HALO, "sp"))


def noise_batch_on_mesh(y: torch.Tensor, fast: FastStack,
                        mesh: m.Mesh) -> torch.Tensor:
    """edge-pad the width so every "sp" shard is even, shard, denoise,
    gather (on y's device), crop back."""
    sp = mesh.axis_size("sp")
    n, h, w = y.shape
    yp = m.edge_pad(y, (n, h, -(-w // (2 * sp)) * (2 * sp)))
    out = noise_plane_sharded(m.shard(yp, mesh, _PLANE), fast, mesh)
    return m.gather(out, y.device)[:, :, :w]


def pad_width_to_mesh(yuv: torch.Tensor,
                      mesh: m.Mesh) -> "tuple[torch.Tensor, int]":
    """Edge-pad the width so it divides the "sp" axis; returns (padded,
    orig_w). Replicate-padding composes with the stack's own replicate
    borders, so cropping the output back is exact."""
    sp = mesh.axis_size("sp")
    n, h, w, c = yuv.shape
    return m.edge_pad(yuv, (n, h, -(-w // sp) * sp)), w


def convert_batch_on_mesh(yuv: torch.Tensor, fast: FastStack,
                          mesh: m.Mesh) -> torch.Tensor:
    """pad -> shard -> 2x step -> gather (on yuv's device) -> crop: the
    polyphase u8 output [N, hl, wl, 12]."""
    yp, w = pad_width_to_mesh(yuv, mesh)
    out = scale2x_u8_s2d_sharded(m.shard(yp, mesh, _YUV), fast, mesh)
    return m.gather(out, yuv.device)[:, :, :w, :]
