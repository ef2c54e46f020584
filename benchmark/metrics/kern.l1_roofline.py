"""csrc/l1.cu's layer 1 (`l1_conv`) against its roofline: the least time,
the larger of its operations at the type's peak and its bytes at the
memory's (the input plane read once, the 32 channels of x1 written once),
over its device time in the trace."""

from benchmark import counts

KERNELS = {"l1_conv"}


def ops_bytes(call: counts.StackCall) -> tuple:
    """Layer 1 of one stack call: the scale stack reads the low-res plane,
    the noise stack the full-res one, each in the storage type."""
    dt = counts.DTYPE_BYTES[call.dtype]
    rows, cols = call.plane(1)
    plane = call.n * call.h * call.w
    return call.layer_ops(1), dt * (plane + call.n * 32 * rows * cols)


def read(run):
    t = run.kernel_seconds(KERNELS)
    if not t:
        return None
    bound = sum(k * c.bound_s(*ops_bytes(c)) for c, k in run.calls.items())
    return 100.0 * bound / t
