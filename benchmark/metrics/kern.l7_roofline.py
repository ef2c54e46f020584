"""csrc/l7.cu's folded layer 7 (`l7_fold` in bf16, `l7_fold_f32` in f32)
against its roofline: the larger of its operations at the type's peak and
its bytes (x6 read once; Y written once, four values a cell in the storage
type, or with W2X_TAIL=kernel the 8 f32 U/V phases read and the 16-byte
u8 cell written), over its device time in the trace."""

from benchmark import counts

KERNELS = {"l7_fold", "l7_fold_f32"}


def ops_bytes(call: counts.StackCall, u8_tail: bool) -> tuple:
    dt = counts.DTYPE_BYTES[call.dtype]
    rows, cols = call.plane(6)
    hc, wc = call.cells
    cells = call.n * hc * wc
    out = (8 * 4 + 16) * cells if u8_tail else 4 * dt * cells
    return call.layer_ops(7), dt * call.n * 128 * rows * cols + out


def read(run):
    t = run.kernel_seconds(KERNELS)
    if not t:
        return None
    u8_tail = run.workload.get("env", {}).get("W2X_TAIL") == "kernel"
    bound = sum(k * c.bound_s(*ops_bytes(c, u8_tail and c.role == "scale"))
                for c, k in run.calls.items())
    return 100.0 * bound / t
