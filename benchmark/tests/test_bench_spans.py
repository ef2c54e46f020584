"""The readers of the program's spans (benchmark/spans.py and the six
metrics that use it): on canned records, with nothing to read, and with
the tracer absent, as in a checkout of a program without it. On the card
(skipped elsewhere) a short traced run: every new metric is read, and the
spans' device times nest."""

import sys
import time

import pytest

from benchmark import harness
from benchmark.counts import StackCall
from waifu2x_torch.utils import trace

SCALE = StackCall("scale", "bfloat16", 16, 512, 512)
NEW = ("stack.device_ms_per_mp", "pipeline.tail_ms_per_mp",
       "pipeline.colour_ms_per_mp", "pipeline.self_ms_per_mp",
       "pipeline.host_enqueue_ms", "setup.prep_s")


def rec(name, i, parent, device_ms=None, host_ms=1.0):
    return trace.Record(name, i, parent, 0, {}, 0, int(host_ms * 1e6),
                        _device_ms=device_ms)


def canned_records():
    """Two dispatches of a chain: the colour map, a noise step (its stack
    and the handoff cast), a banded scale step (two bands, each a stack and
    a tail), and one set-up span."""
    recs = [rec("w2x.setup.prep", 0, None, host_ms=250.0)]
    i = 1
    for _ in range(2):
        recs += [rec("w2x.colour", i, None, 0.5), rec("w2x.colour", i + 1,
                                                      None, 0.25)]
        noise, scale = i + 2, i + 3
        recs += [rec("w2x.noise_step", noise, None, 40.0, host_ms=3.0),
                 rec("w2x.stack", i + 4, noise, 38.0),
                 rec("w2x.scale_step", scale, None, 30.0, host_ms=2.0)]
        for b in (i + 5, i + 6):
            recs += [rec("w2x.band", b, scale, 14.5),
                     rec("w2x.stack", b + 10, b, 12.0),
                     rec("w2x.tail", b + 20, b, 2.0)]
        i += 40
    return recs


def run_of(dispatches=2, out_px=None):
    out_px = dispatches * SCALE.out_px() if out_px is None else out_px
    return harness.Run("c", {}, {"env": {}}, 10.0, 5.0, dispatches, out_px,
                       [1.0] * dispatches, {SCALE: dispatches}, {}, 0)


def read(name, run):
    return harness.load_reader(name)(run)


def test_readers_on_canned_records(monkeypatch):
    monkeypatch.setattr(trace, "records", canned_records)
    run = run_of()
    mp = run.out_px / 1e6
    assert read("stack.device_ms_per_mp", run) == pytest.approx(
        2 * (38.0 + 24.0) / mp)
    assert read("pipeline.tail_ms_per_mp", run) == pytest.approx(8.0 / mp)
    assert read("pipeline.colour_ms_per_mp", run) == pytest.approx(1.5 / mp)
    # step roots 2 x 70 ms, less what their stacks and tails cover
    assert read("pipeline.self_ms_per_mp", run) == pytest.approx(
        2 * (70.0 - 38.0 - 24.0 - 4.0) / mp)
    assert read("pipeline.host_enqueue_ms", run) == pytest.approx(5.0)
    assert read("setup.prep_s", run) == pytest.approx(0.25)


def test_colour_inside_a_step_is_not_its_self_time(monkeypatch):
    recs = [rec("w2x.scale_step", 1, None, 10.0),
            rec("w2x.colour", 2, 1, 1.0), rec("w2x.band", 3, 1, 8.0),
            rec("w2x.stack", 4, 3, 6.0), rec("w2x.tail", 5, 3, 1.5)]
    monkeypatch.setattr(trace, "records", lambda: recs)
    run = run_of(1, out_px=2_000_000)
    assert read("pipeline.self_ms_per_mp", run) == pytest.approx(1.5 / 2)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(monkeypatch, name):
    """No records, records without device time (the CPU), or no dispatch
    read as None; set-up spans alone give only setup.prep_s."""
    monkeypatch.setattr(trace, "records", lambda: [])
    assert read(name, run_of()) is None
    cpu = [rec(r.name, r.id, r.parent, None, r.host_ms)
           for r in canned_records()]
    monkeypatch.setattr(trace, "records", lambda: cpu)
    host_only = {"pipeline.host_enqueue_ms", "setup.prep_s"}
    assert (read(name, run_of()) is None) == (name not in host_only)
    monkeypatch.setattr(trace, "records", canned_records)
    if name != "setup.prep_s":
        assert read(name, run_of(0, 0)) is None
    setup = [r for r in canned_records() if r.name.startswith("w2x.setup.")]
    monkeypatch.setattr(trace, "records", lambda: setup)
    assert (read(name, run_of()) is None) == (name != "setup.prep_s")


@pytest.mark.parametrize("name", NEW)
def test_tracer_absent(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "waifu2x_torch.utils.trace", None)
    assert read(name, run_of()) is None


def test_spans_of_a_traced_run_on_the_card(card):
    trace.reset()
    wl = harness.workload("scale2x.b16_512")
    result = harness.run_cell(wl, 2 ** 31 + 7, 2.0, True, card,
                              time.perf_counter(), log=lambda line: None)
    assert result["correct"], result["checks"]
    for name in NEW:
        assert result["metrics"][name]["value"] > 0, name
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    window = [r for r in recs if not r.name.startswith("w2x.setup.")]
    assert window and all(r.device_ms >= 0 for r in window)
    for r in window:
        if r.parent is not None:
            assert r.device_ms <= by_id[r.parent].device_ms, r.name
