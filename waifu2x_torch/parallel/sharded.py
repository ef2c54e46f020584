"""Multi-device execution of the non-kernel conv stack (the counterpart of
the JAX package's parallel/sharded.py): the plane is split over a 2-D
("dy", "dx") mesh; each position holds one contiguous sub-plane, and the
model-offset halo rims that the reference recomputed per block
(convertRoutine.cpp:84-168) are exchanged once per stack (mesh.halo).
Positions at the true image edges replicate-pad instead (the reference's
BORDER_REPLICATE).

Corners: the halos go rows first, then the columns of the row-extended
block, so the column strips carry the vertical neighbours' rows too and the
diagonal pixels arrive without diagonal sends. Each position runs
ops/convstack.py's conv_stack_valid (F.conv2d, TF32 off) on its extended
block, so the sharded plane is the monolithic one
(tests/test_torch_sharded.py).
"""

from __future__ import annotations

import torch

from waifu2x_torch.ops.convstack import conv_stack_valid
from waifu2x_torch.parallel import mesh as m


def make_mesh(shape: "tuple[int, int] | None" = None,
              devices=None) -> m.Mesh:
    """A ("dy", "dx") spatial mesh over `devices` (default: every card).
    Default shape: all devices in one row (pure width sharding)."""
    if devices is None:
        devices = m.local_devices()
    if shape is None:
        shape = (1, len(devices))
    return m.make_mesh(shape, ("dy", "dx"), devices)


def _exchange_rows(y: m.Sharded, k: int, axis_name: str,
                   dim: int = 0) -> m.Sharded:
    """Attach k halo rows (slices of `dim`) above and below from the mesh
    neighbours along axis_name; replicate the own edge rows at the true
    image boundary."""
    return m.halo(y, k, axis_name, dim)


def _halo_extend(y: m.Sharded, k: int) -> m.Sharded:
    """[h, w] blocks -> [h+2k, w+2k] with halos from both mesh axes: rows
    first, then the columns of the row-extended block (corners ride
    along)."""
    return _exchange_rows(_exchange_rows(y, k, "dy", 0), k, "dx", 1)


def sharded_convert_plane(y: m.Sharded, params, mesh: m.Mesh) -> m.Sharded:
    """The conv stack on a plane sharded ("dy", "dx") over the mesh: f32
    [H, W] with H % dy == 0 and W % dx == 0 (pad first with pad_to_mesh) ->
    f32 [H, W], sharded the same way, equal to convert_plane."""
    offset = sum(int(p["w"].shape[0]) // 2 for p in params)
    reps = m.replicate(params, mesh)

    def local(ext: torch.Tensor) -> torch.Tensor:
        return conv_stack_valid(ext[None, ..., None],
                                reps[ext.device])[0, ..., 0]

    return m.shard_map(local, _halo_extend(y, offset))


def pad_to_mesh(y: torch.Tensor, mesh: m.Mesh
                ) -> "tuple[torch.Tensor, tuple[int, int]]":
    """Edge-pad a plane so both dims divide the mesh shape (replicate rows
    beyond the image are halo-consistent: replicate of replicate is
    replicate). Returns (padded, (h, w))."""
    ny, nx = mesh.shape
    h, w = y.shape
    return m.edge_pad(y, (-(-h // ny) * ny, -(-w // nx) * nx)), (h, w)


def convert_plane_on_mesh(y: torch.Tensor, params,
                          mesh: m.Mesh) -> torch.Tensor:
    """pad -> shard -> convert -> gather -> crop, on y's device."""
    yp, (h, w) = pad_to_mesh(y, mesh)
    out = sharded_convert_plane(m.shard(yp, mesh, ("dy", "dx")), params,
                                mesh)
    return m.gather(out, y.device)[:h, :w]
