"""csrc/mma.cu (`conv3x3_bias_leaky_mma`) on UpCUNet's 3x3 layers of widths
32 -> 64, 64 -> 64, 64 -> 128 and 128 -> 64 against their roofline: for
each layer of each tile the larger of its operations at 989 TFLOP/s and
its bytes (input read once, output written once, weights once) at
3.35 TB/s, summed (benchmark/cunet_counts.py), over the kernel's device
time in the trace."""

from benchmark.cunet_counts import CunetCall

KERNELS = {"conv3x3_bias_leaky_mma"}


def read(run):
    t = run.kernel_seconds(KERNELS)
    bound = sum(n * c.mma_bound_s() for c, n in run.calls.items()
                if isinstance(c, CunetCall))
    if not t or not bound:
        return None
    return 100.0 * bound / t
