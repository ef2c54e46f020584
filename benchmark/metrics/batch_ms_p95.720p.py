"""batch_ms_p95 over the window's dispatches of 720 x 1280 frames
alone: the 95th percentile of their latency, from the end of the
dispatch `depth` places earlier (when the closed loop enqueues it) to
their own end."""

import numpy as np

SIZE = (720, 1280)


def read(run):
    lat = [t for t, hw in zip(run.latency_ms, run.sizes) if tuple(hw) == SIZE]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
