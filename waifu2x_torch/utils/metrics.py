"""Quality + throughput metrics (the observability the reference lacks:
the C++ tool only printed progress lines)."""

from __future__ import annotations

import math

import numpy as np


def psnr(a, b, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB; the fidelity metric (bar: >= 50 dB
    against the f32 reference)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(peak * peak / mse)


def megapixels(shape) -> float:
    h, w = shape[:2]
    return h * w / 1e6


class Throughput:
    """Simple MP/s aggregator for pipeline stages."""

    def __init__(self):
        self.pixels = 0
        self.seconds = 0.0

    def add(self, n_pixels: int, seconds: float) -> None:
        self.pixels += n_pixels
        self.seconds += seconds

    @property
    def mp_per_s(self) -> float:
        return self.pixels / self.seconds / 1e6 if self.seconds else 0.0
