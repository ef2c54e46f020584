"""csrc/mma_tf32.cu's layers 2-6 in f32 (`conv3x3_bias_leaky_tf32`, three
TF32 products a multiply-add) against their roofline: for each layer the
larger of its operations at the TF32 rate, 495 TFLOP/s (one product: the
3xTF32 kernel's ceiling is a third of it), and its bytes at 3.35 TB/s,
summed, over their device time in the trace."""

from benchmark import counts

KERNELS = {"conv3x3_bias_leaky_tf32"}
DTYPE = "float32"


def ops_bytes(call: counts.StackCall, k: int) -> tuple:
    return call.layer_ops(k), call.layer_bytes(k)


def read(run):
    t = run.kernel_seconds(KERNELS)
    if not t:
        return None
    bound = sum(n * c.bound_s(*ops_bytes(c, k)) for c, n in run.calls.items()
                if c.dtype == DTYPE for k in range(2, 7))
    return 100.0 * bound / t
