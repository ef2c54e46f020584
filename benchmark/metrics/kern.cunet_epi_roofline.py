"""csrc/epi.cu (`cunet_epilogue`: the bias, LeakyReLU and cropped skip add
after each of UpCUNet's library convolutions) against its roofline, which
is bytes: for each layer of each tile that is neither an SE block's 1x1 nor
a 3x3 of the widths csrc/mma.cu takes, its output read once and written
once in the step's dtype, and for each transposed 2x2 layer its skip read
once at the output's size (benchmark/cunet_counts.py's shapes), at
3.35 TB/s, over the kernel's device time in the trace."""

from benchmark.counts import DTYPE_BYTES, HBM_BYTES_PER_S
from benchmark.cunet_counts import MMA_WIDTHS, CunetCall, layers

KERNELS = {"cunet_epilogue"}


def tile_bytes(call: CunetCall) -> int:
    """The epilogue's bytes over one tile of `call`."""
    values = 0
    for _, kind, ci, co, _, s_out in layers(call.tile):
        if kind in ("s1", "s2") or (kind == "c3" and (ci, co) in MMA_WIDTHS):
            continue
        values += co * s_out ** 2 * (3 if kind == "up" else 2)
    return DTYPE_BYTES[call.dtype] * values


def read(run):
    t = run.kernel_seconds(KERNELS)
    bound = sum(n * c.tiles * tile_bytes(c) for c, n in run.calls.items()
                if isinstance(c, CunetCall)) / HBM_BYTES_PER_S
    if not t or not bound:
        return None
    return 100.0 * bound / t
