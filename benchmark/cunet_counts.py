"""The yardstick's arithmetic for UpCUNet (configs/upcunet2x.json states the
model): the shapes of its convolutions over one tile, from the plain
reference (independent of the program), and a dispatch's call, which the
adapter (families/upcunet.py) reports and the readers count.

Every count is of what the model needs: each convolution of each tile at
its full size (the tiles' halos are the model's, since each tile is its own
function of its SE means), each input byte read once and each output byte
written once.
"""

from __future__ import annotations

import dataclasses

from benchmark.counts import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS
from benchmark.reference.upcunet import HALO, shapes

# (ci, co) of the 3x3 layers the program runs on csrc/mma.cu
MMA_WIDTHS = frozenset({(32, 64), (64, 64), (64, 128), (128, 64)})
_TAPS = {"c3": 9, "dn": 4, "up": 4, "up4": 16, "s1": 1, "s2": 1}


def layers(tile: int) -> list:
    """Every convolution of one tile of `tile` pixels a side, in the order
    the forward pass runs them: (name, kind, ci, co, input side, output
    side), as the plain reference's table and forward pass give them
    (reference/upcunet.py: LAYERS, shapes); kind "c3" 3x3, "dn" 2x2
    stride 2, "up" transposed 2x2 stride 2, "up4" transposed 4x4 stride 2
    pad 3, "s1" / "s2" an SE block's 1x1 convs on its vector."""
    return shapes(tile)


def layer_macs(kind: str, ci: int, co: int, s_in: int, s_out: int) -> int:
    px = s_in * s_in if kind in ("up", "up4") else s_out * s_out
    return px * _TAPS[kind] * ci * co


@dataclasses.dataclass(frozen=True)
class CunetCall:
    """One dispatch's UpCUNet step: n frames of h x w, cut into tiles of
    `tile` pixels a side at the step tile - 2 HALO, in `dtype`."""

    dtype: str
    n: int
    h: int
    w: int
    tile: int

    @property
    def tiles(self) -> int:
        step = self.tile - 2 * HALO
        return self.n * -(-self.h // step) * -(-self.w // step)

    def flops(self) -> int:
        """Every convolution of every tile, two a multiply-add."""
        return 2 * self.tiles * sum(layer_macs(*l[1:])
                                    for l in layers(self.tile))

    def mma_bound_s(self) -> float:
        """The least time of the layers on csrc/mma.cu: for each, the larger
        of its operations at the type's peak and its bytes (input read once,
        output written once, weights once) at the memory's, summed."""
        dt = DTYPE_BYTES[self.dtype]
        total = 0.0
        for _, kind, ci, co, s_in, s_out in layers(self.tile):
            if kind != "c3" or (ci, co) not in MMA_WIDTHS:
                continue
            ops = 2.0 * self.tiles * layer_macs(kind, ci, co, s_in, s_out)
            nbytes = dt * (self.tiles * (ci * s_in ** 2 + co * s_out ** 2)
                           + 9 * ci * co)
            total += max(ops / PEAK_FLOPS[self.dtype],
                         nbytes / HBM_BYTES_PER_S)
        return total
