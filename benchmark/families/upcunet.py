"""The program's side of waifu2x UpCUNet: the port's model built by its
public set-up (`StreamConverter.from_cunet_params`, the configuration's
stated type and tile) and its batched step, `pipeline.upcunet2x_batch_u8`,
as the stream runs it.

A dispatch: the u8 BGR batch mapped to RGB in [0, 1] (`prepare`, the
stream's `unit_rgb`), then the step: the frames cut into tiles, each tile
through UpCUNet, the tiles' u8 outputs stitched into u8 BGR frames of twice
the size, which need no interleave.
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STRIP_ROWS = 2      # output rows of one input row: row_psnr_min_db


class Program:
    """The model of `cfg`'s one stack (role "upcunet") from `weights` (role
    -> the reference's {"params", "tile"}), and one dispatch's calls."""

    def __init__(self, cfg: dict, weights: dict, device):
        import torch
        from waifu2x_torch.pipeline import unit_rgb, upcunet2x_batch_u8
        from waifu2x_torch.stream import StreamConverter
        from waifu2x_torch.utils.cache import enable_compilation_cache
        enable_compilation_cache(str(ROOT / "waifu2x_torch" / "build"))
        (stack,) = cfg["stacks"]
        w = weights[stack["role"]]
        if w["tile"] != stack["tile"]:
            raise RuntimeError(f"weights for tile {w['tile']}, the "
                               f"configuration states {stack['tile']}")
        conv = StreamConverter.from_cunet_params(
            w["params"], dtype=getattr(torch, stack["dtype"]),
            device=device, tile=stack["tile"])
        self.model = conv.cunet
        got = str(self.model.dtype).replace("torch.", "")
        if got != stack["dtype"] or self.model.tile != stack["tile"]:
            raise RuntimeError(f"the model runs {got} on {self.model.tile} "
                               f"px tiles; the configuration states "
                               f"{stack['dtype']} on {stack['tile']}")
        self.dtype, self.tile = stack["dtype"], stack["tile"]
        self.device = torch.device(device)
        self._unit, self._step = unit_rgb, upcunet2x_batch_u8

    def prepare(self, x):
        """u8 BGR [n, h, w, 3] on the device -> f32 RGB in [0, 1]."""
        return self._unit(x)

    def step(self, rgb):
        """f32 RGB [n, h, w, 3] -> (u8 BGR [n, 2h, 2w, 3], None)."""
        return self._step(rgb, self.model), None

    def calls(self, batch) -> list:
        """One dispatch's step, as the yardstick counts it: every
        convolution of every tile (benchmark/cunet_counts.py)."""
        from benchmark.cunet_counts import CunetCall
        return [CunetCall(self.dtype, batch.n, batch.h, batch.w, self.tile)]

    def out_px(self, batch) -> int:
        return batch.n * 4 * batch.h * batch.w

    def out_shape(self, batch) -> tuple:
        return batch.n, 2 * batch.h, 2 * batch.w, 3

    def frames(self, out):
        """The step's u8 BGR frames, as they are."""
        return out


def build(cfg: dict, weights: dict, device) -> Program:
    return Program(cfg, weights, device)
