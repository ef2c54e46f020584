"""The program's spans (waifu2x_torch.utils.trace) as the per-layer readers
read them, in the process that ran the window. The tracer records only
while a profiler records, and run_cell profiles the traced window alone
(after the warm-up pass), so the records are that window's, and the
set-up spans (w2x.setup.*), which record always. Against a program that
has no tracer, or recorded nothing, every function here gives None."""

from __future__ import annotations

import importlib

STEPS = ("w2x.scale_step", "w2x.noise_step")
# the spans whose device time a step's own (self) time leaves out
COVERED = ("w2x.stack", "w2x.tail", "w2x.colour")


def records():
    """The program's span records, or None."""
    try:
        trace = importlib.import_module("waifu2x_torch.utils.trace")
    except ImportError:
        return None
    return trace.records() or None


def _named(recs, names) -> list:
    return [r for r in recs or () if r.name in names]


def device_ms(names) -> "float | None":
    """Device ms summed over the spans named in `names`; None where there
    is none, or one has no device time."""
    got = _named(records(), names)
    if not got or any(r.device_ms is None for r in got):
        return None
    return sum(r.device_ms for r in got)


def host_ms(names) -> "float | None":
    """Host ms summed over the spans named in `names`; None where there is
    none."""
    got = _named(records(), names)
    return sum(r.host_ms for r in got) if got else None


def self_ms() -> "float | None":
    """Device ms of the step spans not covered by the COVERED spans below
    them (each counted under its nearest step)."""
    recs = records()
    steps = _named(recs, STEPS)
    if not steps or any(r.device_ms is None for r in steps):
        return None
    by_id = {r.id: r for r in recs}
    total = sum(r.device_ms for r in steps)
    for r in _named(recs, COVERED):
        up = by_id.get(r.parent)
        while up is not None and up.name not in STEPS:
            up = by_id.get(up.parent)
        if up is not None:
            total -= r.device_ms
    return total


def per_mp(run, ms) -> "float | None":
    """`ms` over the window's output megapixels."""
    if ms is None or not run.out_px:
        return None
    return ms / (run.out_px / 1e6)
