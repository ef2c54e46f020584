"""The share of the traced window in which no operation (kernel, copy or
set) ran on the device: one less the union of the device intervals over
the window."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
