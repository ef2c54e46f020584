"""The comparison that decides `correct`: the frames the timed path wrote
against the plain reference's, by numbers that each have a limit."""

from __future__ import annotations

import math

import torch

PSNR_CAP_MSE = 1e-10   # a frame equal to the reference reads 148 dB, not inf


def psnr_db(mse: float) -> float:
    return 10.0 * math.log10(255.0 ** 2 / max(mse, PSNR_CAP_MSE))


def frame_numbers(got: torch.Tensor, ref: torch.Tensor, strip_rows: int):
    """u8 frames [N, H, W, 3] against the reference's -> (the PSNR of each
    frame, the least PSNR of any strip of strip_rows output rows)."""
    d = (got.to(torch.float32) - ref.to(torch.float32)) ** 2
    n, rows = d.shape[:2]
    frames = [psnr_db(float(m)) for m in d.reshape(n, -1).mean(dim=1)]
    per_row = d.mean(dim=(2, 3))                       # [N, H]
    k = -(-rows // strip_rows)
    pad = k * strip_rows - rows
    if pad:   # the last strip is the last strip_rows rows of the frame
        per_row = torch.cat([per_row[:, :rows - strip_rows + pad],
                             per_row[:, rows - strip_rows:]], dim=1)
    strips = per_row.reshape(n, k, strip_rows).mean(dim=2)
    return frames, psnr_db(float(strips.max()))


class Numbers:
    """The numbers of one run, accumulated over the checked batches, each
    beside its limit: `frame_psnr_min_db` (dB, the least of a checked
    frame) and `row_psnr_min_db` (dB, the least of any strip of output rows
    that one low-res row makes, where a band's seam shows), each at least
    its limit, and for a chain `noise_y_maxabs` (the denoised plane's
    largest gap to the reference, at most the limit)."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {}

    def _low(self, name: str, v: float) -> None:
        self.values[name] = min(self.values.get(name, math.inf), v)

    def add_frames(self, got: torch.Tensor, ref: torch.Tensor,
                   strip_rows: int) -> None:
        frames, strip = frame_numbers(got, ref, strip_rows)
        self._low("frame_psnr_min_db", min(frames))
        self._low("row_psnr_min_db", strip)

    def add_plane(self, y: torch.Tensor, y_ref: torch.Tensor) -> None:
        gap = float((y.to(torch.float32) - y_ref).abs().max())
        self.values["noise_y_maxabs"] = max(
            self.values.get("noise_y_maxabs", 0.0), gap)

    def merge(self, other: "Numbers") -> None:
        for name, v in other.values.items():
            if name.endswith("_db"):
                self._low(name, v)
            else:
                self.values[name] = max(self.values.get(name, v), v)

    def table(self) -> dict:
        """name -> {"value", "limit", "pass"}: dB numbers pass at or above
        their limit, gaps at or below it. A number with no reading fails."""
        out = {}
        for name, limit in self.limits.items():
            v = self.values.get(name)
            ok = v is not None and (v >= limit if name.endswith("_db")
                                    else v <= limit)
            out[name] = {"value": v, "limit": limit, "pass": ok}
        return out

    def ok(self) -> bool:
        return all(row["pass"] for row in self.table().values())
