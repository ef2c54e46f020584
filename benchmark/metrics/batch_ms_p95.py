"""The 95th percentile over the window's dispatches of a dispatch's latency:
from the end of the dispatch `depth` places earlier (when the closed loop
enqueues it; the window's start for the first `depth`) to its own end,
both CUDA events, read on the device's clock."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latency_ms, np.float64), 95))
