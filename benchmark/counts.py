"""The yardstick's arithmetic: the chip's peaks, and the shapes of the work
a dispatch asks for, from which the per-layer readers count a kernel's
operations and bytes.

Every count is of what the inputs need, never of what an implementation
chose to do: a stack call runs on the whole frame (bands and their halos
are the program's choice and are not counted), each input byte is read
once and each output byte written once.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}   # f32 at the TF32 rate
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# the 7-layer VGG: (input, output) channels of each 3x3 layer
WIDTHS = ((1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
          (128, 1))
TAPS = 9
MAC_PER_PX = TAPS * sum(ci * co for ci, co in WIDTHS)   # 287,136


def flops_per_px() -> int:
    """Model operations for one pixel of a stack's output plane."""
    return 2 * MAC_PER_PX


@dataclasses.dataclass(frozen=True)
class StackCall:
    """One model over a batch: `role` "scale" (input: the low-res Y plane,
    output at twice its size) or "noise" (input and output the full-res
    plane), `dtype` its storage type, n frames of the h x w input plane."""

    role: str
    dtype: str
    n: int
    h: int
    w: int

    @property
    def cells(self) -> tuple:
        """The s2d cells of the output: a cell is 2 x 2 output pixels."""
        if self.role == "scale":
            return self.h, self.w
        return -(-self.h // 2), -(-self.w // 2)

    def plane(self, k: int) -> tuple:
        """Rows and columns of x_k, the output of layer k (1..7): the
        output plane padded by 7, less one on each side a layer."""
        hc, wc = self.cells
        return 2 * hc + 14 - 2 * k, 2 * wc + 14 - 2 * k

    def out_px(self) -> int:
        """Pixels of the output plane, per frame times frames."""
        hc, wc = self.cells
        return self.n * 4 * hc * wc

    def flops(self) -> int:
        """The model's operations over the whole output plane."""
        return self.out_px() * flops_per_px()

    def layer_ops(self, k: int) -> float:
        """Operations of layer k (1..7) over its whole output plane."""
        ci, co = WIDTHS[k - 1]
        rows, cols = self.plane(k)
        return 2.0 * TAPS * ci * co * self.n * rows * cols

    def layer_bytes(self, k: int) -> float:
        """Bytes of layers 2-6 (k = 2..6): x_{k-1} read once, x_k written
        once, the weights read once."""
        ci, co = WIDTHS[k - 1]
        dt = DTYPE_BYTES[self.dtype]
        rin, cin = self.plane(k - 1)
        rout, cout = self.plane(k)
        return dt * (self.n * (ci * rin * cin + co * rout * cout)
                     + TAPS * ci * co)

    def bound_s(self, ops: float, nbytes: float) -> float:
        """The least time the chip could take: the larger of the operations
        at the type's peak and the bytes at the memory's."""
        return max(ops / PEAK_FLOPS[self.dtype], nbytes / HBM_BYTES_PER_S)
