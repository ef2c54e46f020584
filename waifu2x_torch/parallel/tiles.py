"""Single-device block tiler: batched halo tiles for large planes on the
non-kernel path (the counterpart of the JAX package's parallel/tiles.py).

It replaces the reference's sequential block splitter
(convertWithModelsBlockSplit, convertRoutine.cpp:84-168; design notes
appendix/hints-jp.md:42-63) with the same halo invariant: every tile
carries an `offset`-pixel rim, so the stitched interiors equal a monolithic
pass. As in the JAX package:

  * the plane is edge-padded up to an exact multiple of the tile grid (the
    original Lua tiler's trick, reconstruct.lua:36-43), so every tile has
    one shape; replicate(replicate(x)) == replicate(x), so results do not
    change;
  * tiles are batched on the leading axis and run through the model's
    F.conv2d stack (TF32 off) in chunks of `batch_tiles`, the last chunk
    padded with repeated tiles, as lax.scan's is;
  * stitching is a reshape and a transpose.

Whether to tile at all is the caller's decision (pipeline._convert_y, the
reference's W*H > blockW*blockH*3/2 rule).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TilePlan:
    h: int                # original plane height
    w: int                # original plane width
    tile: int             # tile side incl. halo (reference blockSize, 512)
    offset: int           # halo width = model receptive radius (7)
    ny: int               # tile grid rows
    nx: int               # tile grid cols
    stride: int           # tile - 2*offset (valid output per tile side)
    hp: int               # padded grid height = ny*stride
    wp: int               # padded grid width  = nx*stride

    @property
    def n_tiles(self) -> int:
        return self.ny * self.nx

    @property
    def redundancy(self) -> float:
        """Fraction of conv work spent on halos and grid padding."""
        return 1.0 - self.h * self.w / (self.n_tiles * self.tile * self.tile)


def plan_tiles(h: int, w: int, tile: int, offset: int) -> TilePlan:
    stride = tile - 2 * offset
    if stride <= 0:
        raise ValueError(f"tile ({tile}) must exceed 2*offset ({2 * offset})")
    ny = -(-h // stride)
    nx = -(-w // stride)
    return TilePlan(h, w, tile, offset, ny, nx, stride, ny * stride, nx * stride)


def extract_tiles(y: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """[H, W] -> [N, tile, tile] overlapping tiles (halo included), in
    row-major grid order."""
    k, s, t = plan.offset, plan.stride, plan.tile
    yp = F.pad(y[None, None],
               (k, k + plan.wp - plan.w, k, k + plan.hp - plan.h),
               mode="replicate")[0, 0]            # (hp + 2k, wp + 2k)
    rows = yp.unfold(0, t, s)                     # [ny, wp + 2k, t]
    tiles = rows.unfold(1, t, s)                  # [ny, nx, t(rows), t]
    return tiles.reshape(-1, t, t)


def stitch_tiles(outs: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """[N, stride, stride] tile interiors -> [H, W] plane."""
    s = plan.stride
    grid = outs.reshape(plan.ny, plan.nx, s, s).transpose(1, 2)
    return grid.reshape(plan.hp, plan.wp)[: plan.h, : plan.w]


def tiled_convert(y: torch.Tensor, model, plan: TilePlan,
                  batch_tiles: int = 8) -> torch.Tensor:
    """Run `model` (an SRCNN: VALID F.conv2d stack, TF32 off) over a plane
    [H, W] in batched halo tiles -> [H, W]. The interiors equal the
    monolithic pass (model.convert_plane)."""
    tiles = extract_tiles(y, plan)
    n = tiles.shape[0]
    b = max(1, min(batch_tiles, n))
    pad_n = -(-n // b) * b - n
    if pad_n:
        tiles = torch.cat([tiles, tiles[:pad_n]])
    outs = torch.cat([model(chunk[:, None])[:, 0]
                      for chunk in tiles.split(b)])
    return stitch_tiles(outs[:n], plan)
