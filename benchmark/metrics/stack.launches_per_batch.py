"""The program's count of its stack kernels' launches
(waifu2x_torch.ops.stack.LAUNCHES, reset before the window) over the
window's dispatches."""


def read(run):
    if not run.dispatches:
        return None
    return run.counters["stack.LAUNCHES"] / run.dispatches
