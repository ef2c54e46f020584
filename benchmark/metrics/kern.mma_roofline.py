"""csrc/mma.cu's layers 2-6 in bf16 (`conv3x3_bias_leaky_mma`) against their
roofline: for each layer the larger of its operations at 989 TFLOP/s and
its bytes (x_{k-1} read once, x_k written once) at 3.35 TB/s, summed, over
their device time in the trace."""

from benchmark import counts

KERNELS = {"conv3x3_bias_leaky_mma"}
DTYPE = "bfloat16"


def ops_bytes(call: counts.StackCall, k: int) -> tuple:
    return call.layer_ops(k), call.layer_bytes(k)


def read(run):
    t = run.kernel_seconds(KERNELS)
    if not t:
        return None
    bound = sum(n * c.bound_s(*ops_bytes(c, k)) for c, n in run.calls.items()
                if c.dtype == DTYPE for k in range(2, 7))
    return 100.0 * bound / t
