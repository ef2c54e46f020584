"""The port's spans: named intervals at its layer boundaries, recorded in
memory while a torch.profiler is recording.

    with trace.span("w2x.stack", on=x, kind="scale") as s:
        ...
        s.set(launches=n)

Off (no profiler recording, the default) `span` returns one shared no-op
object after one check: no record_function range, no CUDA event, no
record. On (a torch.profiler recording on this process: the benchmark's
traced run, the CLI's --profile) a span opens a record_function range of
its name, so it shows in the profiler's trace around the work it launched,
and records its name, its parent (the innermost open span of the thread),
its root's id (the spans of one call share it), its attributes, its host
start and end on the profiler's clock (time.time_ns) and, with `on=` a
CUDA tensor or device, a timing CUDA event at each edge on that device's
current stream for its device time.

Set-up spans (names under SETUP, "w2x.setup.") record their host time
always: they run once a process, before any profiler starts.

`records()` returns the closed spans (device ms read from the events,
None without them); `reset()` clears them. The spans, their attributes and
what reads each: PERF.md, section 3.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import torch

SETUP = "w2x.setup."

_profiling = torch._C._autograd._profiler_enabled
_records: list = []
_ids = itertools.count()
_local = threading.local()


@dataclasses.dataclass
class Record:
    """One closed span. `start_ns` / `end_ns`: the host's clock
    (time.time_ns, the profiler's); `parent` and `root`: span ids (`root`
    is the span's own id for a root)."""

    name: str
    id: int
    parent: "int | None"
    root: int
    attrs: dict
    start_ns: int
    end_ns: int
    events: "tuple | None" = None
    _device_ms: "float | None" = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> "float | None":
        """Device milliseconds between the span's two events (waits for the
        second); None for a span with no events."""
        if self._device_ms is None and self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms


class _Noop:
    """What `span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


NOOP = _Noop()


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stream(on):
    """The current stream of `on`'s device if it is a CUDA tensor or
    device and no graph is being captured, else None."""
    if on is None:
        return None
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(dev)


class _Span:
    __slots__ = ("name", "attrs", "profile", "stream", "rf", "id", "parent",
                 "root", "start_ev", "start_ns")

    def __init__(self, name: str, attrs: dict, profile: bool, on):
        self.name, self.attrs, self.profile = name, attrs, profile
        self.stream = _stream(on) if profile else None

    def __enter__(self):
        stack = _open()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.start_ns = time.time_ns()
        self.rf = None
        if self.profile:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start_ev = None
        if self.stream is not None:
            self.start_ev = torch.cuda.Event(enable_timing=True)
            self.start_ev.record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        events = None
        if self.start_ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start_ev, end)
        _open().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _records.append(Record(self.name, self.id, self.parent, self.root,
                               self.attrs, self.start_ns, end_ns, events))

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, on=None, **attrs):
    """A context manager around one layer's work: see the module
    docstring. `on`, a tensor or device, gives device time where it is a
    CUDA one."""
    if _profiling():
        return _Span(name, attrs, True, on)
    if name.startswith(SETUP):
        return _Span(name, attrs, False, None)
    return NOOP


def records() -> list:
    """The closed spans, in the order they closed."""
    return list(_records)


def reset() -> None:
    """Forget every closed span."""
    _records.clear()


def summary() -> dict:
    """name -> {"count", "host_s", "device_s", "attrs"} over records():
    device_s is None where no span of the name had events; "attrs" holds
    each numeric attribute summed, each other one as its distinct values
    (text, sorted)."""
    out = {}
    for r in records():
        s = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "device_s": None, "attrs": {}})
        s["count"] += 1
        s["host_s"] += r.host_ms * 1e-3
        if r.device_ms is not None:
            s["device_s"] = (s["device_s"] or 0.0) + r.device_ms * 1e-3
        for k, v in r.attrs.items():
            if isinstance(v, (int, float)):
                s["attrs"][k] = s["attrs"].get(k, 0) + v
            else:
                s["attrs"].setdefault(k, set()).add(
                    str(tuple(v)) if isinstance(v, tuple) else str(v))
    for s in out.values():
        s["attrs"] = {k: sorted(v) if isinstance(v, set) else v
                      for k, v in s["attrs"].items()}
    return out
