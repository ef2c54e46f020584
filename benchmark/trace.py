"""The profiler trace of a window, reduced to what the per-layer readers
read: device intervals (kernels, copies, sets) and the benchmark's own host
spans, on one timeline, clipped to the window's span."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from pathlib import Path

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
LOOK_BACK = 256     # framework operations searched for the one open at a gap
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                     r"\([^()]*\))*\)\s*)?(\w+)\s*\(")


def program_kernels(csrc: Path) -> frozenset:
    """The names of the program's hand-written kernels: every __global__
    function in its CUDA sources."""
    names = set()
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(f.read_text()))
    return frozenset(names)


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


def base_name(name: str) -> str:
    """A kernel's function name, without template arguments."""
    return short_name(name).split("<")[0].split("::")[-1]


@dataclasses.dataclass
class Trace:
    """Intervals in seconds from the window's start: `device` (name, start,
    end) for every operation that ran on the device; `spans` (name, start,
    end) for the benchmark's leaf host spans, which do not overlap; `ops`
    (name, start, end) for the host's framework operations."""

    window_s: float
    device: list
    spans: list
    ops: list = dataclasses.field(default_factory=list)

    def busy(self) -> list:
        """The union of the device intervals, as sorted disjoint (start,
        end) pairs."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name `match(name)`
        accepts."""
        return sum(e - s for name, s, e in self.device if match(name))

    def top_ops(self, k: int = 10) -> list:
        by = collections.Counter()
        for name, s, e in self.device:
            by[short_name(name)] += e - s
        return [[n, t] for n, t in by.most_common(k)]

    def _host_at(self, t: float) -> str:
        """What the host was doing at t: the leaf span around it and the
        innermost framework operation (the latest to start of those that
        hold t, looked for among the LOOK_BACK that started last)."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        span = "bench.between"
        if i >= 0 and self.spans[i][2] >= t:
            span = self.spans[i][0]
        op = "python"
        j = bisect.bisect_right(self._op_starts, t) - 1
        for name, s, e in reversed(self.ops[max(0, j - LOOK_BACK + 1):j + 1]):
            if e >= t:
                op = name
                break
        return f"{span}: {op}"

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device seconds inside the window, summed by what the host
        was doing at each gap's middle; the k largest."""
        self.spans.sort(key=lambda x: x[1])
        self.ops.sort(key=lambda x: x[1])
        self._span_starts = [x[1] for x in self.spans]
        self._op_starts = [x[1] for x in self.ops]
        by = collections.Counter()
        t = 0.0
        for s, e in self.busy() + [(self.window_s, self.window_s)]:
            s, e = max(s, 0.0), min(e, self.window_s)
            if s > t:
                by[self._host_at((t + s) / 2)] += s - t
            t = max(t, e)
        return [[n, v] for n, v in by.most_common(k)]


def from_profiler(prof) -> Trace:
    """The trace of a torch.profiler run whose window is one record_function
    span named WINDOW_SPAN."""
    raw = prof.profiler.kineto_results.events()
    device, host, ops = [], [], []
    window = None
    for ev in raw:
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if str(ev.device_type()).split(".")[-1] != "CPU":
            if not ev.is_user_annotation():
                device.append((name, s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        elif name.startswith(SPAN_PREFIX):
            host.append((name, s, e))
        elif not ev.is_user_annotation():
            ops.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    t0, t1 = window

    def clip(items):   # integer ns from the window's start, then seconds
        return [(n, (max(s, t0) - t0) * 1e-9, (min(e, t1) - t0) * 1e-9)
                for n, s, e in items if e > t0 and s < t1]

    return Trace((t1 - t0) * 1e-9, clip(device), clip(host), clip(ops))
