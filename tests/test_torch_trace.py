"""The port's spans (waifu2x_torch.utils.trace) on the CPU: nothing is
recorded, allocated or opened while no profiler records; under a CPU
torch.profiler the throughput steps and the stream give their spans in
the tree PERF.md names, on the profiler's clock; set-up spans record
always."""

import tracemalloc

import numpy as np
import pytest
import torch

from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops.stack import WIDTHS
from waifu2x_torch.stream import StreamConverter
from waifu2x_torch.utils import trace

torch.set_num_threads(2)
ACTS = [torch.profiler.ProfilerActivity.CPU]


def _params(seed):
    rng = np.random.default_rng(seed)
    return params_from_numpy([
        {"w": (rng.standard_normal((3, 3, ci, co)) * (0.5 / ci) ** 0.5)
         .astype(np.float32), "b": np.zeros(co, np.float32)}
        for ci, co in WIDTHS])


@pytest.fixture(scope="module")
def fast():
    return pl.FastStack.build(_params(1), True, dtype=torch.float32,
                              device="cpu")


@pytest.fixture(scope="module")
def fast_n():
    return pl.FastStack.build(_params(2), False, dtype=torch.float32,
                              device="cpu")


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _yuv(seed, n, h, w):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, h, w, 3), generator=g)


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_opens_records_and_allocates_nothing(fast, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    x = torch.zeros(2)
    assert trace.span("w2x.stack", on=x, kind="scale") is trace.NOOP
    tracemalloc.start()
    try:
        for _ in range(1000):
            with trace.span("w2x.tail", on=x, n=1) as s:
                s.set(k=2)
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(t.size for t in snap.traces) == 0
    out = pl.scale2x_batch_u8_fused(_yuv(0, 1, 130, 8), fast, band_rows=64)
    assert out.shape == (1, 130, 8, 16)
    assert trace.records() == []


@pytest.mark.parametrize("tail", ["xla", "kernel"])
def test_banded_scale_step_tree(fast, monkeypatch, tail):
    """One w2x.scale_step root, one w2x.band a band of _bands with its
    rows, and under each band one w2x.stack and one w2x.tail; every span
    of the call shares the root's id and lies on the profiler's clock."""
    monkeypatch.setattr(pl, "FUSED_TAIL", tail)
    monkeypatch.setattr(pl, "YDENSE", False)
    yuv = _yuv(1, 1, 130, 8)
    with torch.profiler.profile(activities=ACTS) as prof:
        pl.scale2x_batch_u8_fused(yuv, fast, band_rows=64)
    recs = trace.records()
    (root,) = _named(recs, "w2x.scale_step")
    assert root.parent is None
    assert root.attrs == {"n": 1, "size": (130, 8), "out_px": 4 * 130 * 8}
    assert {r.root for r in recs} == {root.id}
    bands = sorted(_named(recs, "w2x.band"), key=lambda r: r.start_ns)
    want = list(pl._bands(130, 64))
    assert len(want) == 3
    assert [(b.attrs["rows"], b.attrs["kept"]) for b in bands] == [
        (size, nrows) for _, size, _, nrows in want]
    assert all(b.parent == root.id for b in bands)
    for b in bands:
        (st,) = [r for r in _named(recs, "w2x.stack") if r.parent == b.id]
        (tl,) = [r for r in _named(recs, "w2x.tail") if r.parent == b.id]
        assert st.attrs["kind"] == ("scale" if tail == "xla" else "fused_u8")
        assert st.attrs["launches"] == 0          # the plain route
        assert tuple(st.attrs["shape"]) == (1, b.attrs["rows"], 8)
    assert len(recs) == 1 + 3 * 3
    assert all(r.device_ms is None for r in recs)
    # the shared clock: each span against the profiler's range of its name
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("w2x.")]
    for name in {r.name for r in recs}:
        mine = sorted((r.start_ns, r.end_ns) for r in _named(recs, name))
        theirs = sorted((e.start_ns(), e.end_ns()) for e in events
                        if e.name() == name)
        assert len(mine) == len(theirs)
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert abs(s - ps) < 1e6 and abs(e - pe) < 1e6, name


def test_chain_and_stream_spans(fast, fast_n):
    """A noise_scale stream on the CPU: a dispatch span a batch with its
    frames and copies, the colour map, w2x.noise_step then w2x.scale_step
    under it; a wait and an interleave span a retired batch."""
    sc = StreamConverter(fast=fast, fast_noise=fast_n, mode="noise_scale",
                         batch=2, depth=1, device="cpu")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
              for _ in range(3)]
    with torch.profiler.profile(activities=ACTS):
        outs = list(sc.process_frames(frames))
    assert len(outs) == 3
    recs = trace.records()
    dispatches = sorted(_named(recs, "w2x.stream.dispatch"),
                        key=lambda r: r.start_ns)
    assert [(d.attrs["frames"], d.attrs["padded"]) for d in dispatches] == [
        (2, 2), (1, 2)]
    for d in dispatches:
        assert d.parent is None
        assert (d.attrs["h2d_bytes"], d.attrs["d2h_bytes"],
                d.attrs["pinned"]) == (0, 0, 0)
        kids = sorted((r for r in recs if r.parent == d.id),
                      key=lambda r: r.start_ns)
        assert [k.name for k in kids] == [
            "w2x.colour", "w2x.colour", "w2x.noise_step", "w2x.scale_step"]
        assert kids[2].attrs["out_px"] * 4 == kids[3].attrs["out_px"]
        assert all(k.root == d.id for k in kids)
    for name in ("w2x.stream.wait", "w2x.stream.interleave"):
        assert len(_named(recs, name)) == 2
        assert all(r.parent is None for r in _named(recs, name))
    attrs = trace.summary()["w2x.stream.dispatch"]["attrs"]
    assert attrs == {"frames": 3, "padded": 4, "h2d_bytes": 0,
                     "d2h_bytes": 0, "pinned": 0}
    steps = trace.summary()["w2x.scale_step"]["attrs"]
    assert steps == {"n": 4, "size": ["(12, 10)"], "out_px": 4 * 4 * 120}


def test_setup_span_records_without_profiler():
    assert not torch._C._autograd._profiler_enabled()
    pl.FastStack.build(_params(4), True, dtype=torch.bfloat16, device="cpu")
    (rec,) = trace.records()
    assert rec.name == "w2x.setup.prep" and rec.parent is None
    assert rec.attrs == {"dtype": torch.bfloat16}
    assert rec.host_ms > 0 and rec.device_ms is None
    assert trace.summary() == {"w2x.setup.prep": {
        "count": 1, "host_s": rec.host_ms * 1e-3, "device_s": None,
        "attrs": {"dtype": ["torch.bfloat16"]}}}


def test_cunet_step_span_tree():
    """UpCUNet's batched step under a CPU profiler: one w2x.cunet_step root
    (n, size, tiles, out_px) over the pad-and-cut and the stitch
    (w2x.cunet.tiles), w2x.cunet.unet1 and w2x.cunet.unet2; below the
    U-Nets the SE blocks (w2x.cunet.se, with their channels), each
    csrc/mma.cu layer's w2x.stack (kind "cunet", ci, co: the plain route
    on the CPU, so no launch and no route) and each library layer's
    epilogue (w2x.cunet.epi, with its mode and channels)."""
    from waifu2x_torch.models import cunet
    from waifu2x_torch.ops import stack, unet
    model = unet.CunetModel.build(cunet.init_params(4), torch.bfloat16,
                                  "cpu", 76)
    x = torch.rand((1, 40, 70, 3))
    stack.reset_launches()
    with torch.profiler.profile(activities=ACTS):
        out = pl.upcunet2x_batch_u8(x, model)
    assert out.shape == (1, 80, 140, 3) and out.dtype == torch.uint8
    recs = [r for r in trace.records() if not r.name.startswith(trace.SETUP)]
    by_id = {r.id: r for r in recs}
    (root,) = _named(recs, "w2x.cunet_step")
    assert root.parent is None and {r.root for r in recs} == {root.id}
    assert root.attrs == {"n": 1, "size": (40, 70), "tiles": 2,
                          "out_px": 4 * 40 * 70}
    tiles = _named(recs, "w2x.cunet.tiles")
    (u1,) = _named(recs, "w2x.cunet.unet1")
    (u2,) = _named(recs, "w2x.cunet.unet2")
    assert len(tiles) == 2
    assert all(r.parent == root.id for r in tiles + [u1, u2])
    se = _named(recs, "w2x.cunet.se")
    assert sorted((by_id[r.parent].name, r.attrs["channels"]) for r in se) \
        == [("w2x.cunet.unet1", 64), ("w2x.cunet.unet2", 64),
            ("w2x.cunet.unet2", 128), ("w2x.cunet.unet2", 128)]
    stacks = _named(recs, "w2x.stack")
    assert sorted((by_id[r.parent].name, r.attrs["ci"], r.attrs["co"])
                  for r in stacks) == sorted(
        [("w2x.cunet.unet1", 32, 64), ("w2x.cunet.unet1", 64, 128),
         ("w2x.cunet.unet1", 128, 64), ("w2x.cunet.unet1", 64, 64),
         ("w2x.cunet.unet2", 32, 64), ("w2x.cunet.unet2", 64, 64),
         ("w2x.cunet.unet2", 64, 128), ("w2x.cunet.unet2", 128, 64),
         ("w2x.cunet.unet2", 64, 64), ("w2x.cunet.unet2", 64, 64)])
    assert all(r.attrs["kind"] == "cunet" and "route" not in r.attrs
               for r in stacks)
    assert stack.LAUNCHES == 0 and stack.MMA_SHAPES == {}
    epi = _named(recs, "w2x.cunet.epi")
    assert sorted((by_id[r.parent].name, r.attrs["mode"], r.attrs["channels"])
                  for r in epi) == sorted(
        [("w2x.cunet.unet1", "bias_leaky", 32),
         ("w2x.cunet.unet1", "bias_leaky", 64),
         ("w2x.cunet.unet1", "bias_leaky_skip", 64),
         ("w2x.cunet.unet1", "bias", 3),
         ("w2x.cunet.unet2", "bias_leaky", 32),
         ("w2x.cunet.unet2", "bias_leaky", 64),
         ("w2x.cunet.unet2", "bias_leaky", 128),
         ("w2x.cunet.unet2", "bias_leaky", 256),
         ("w2x.cunet.unet2", "bias_leaky", 128),
         ("w2x.cunet.unet2", "bias_leaky_skip", 128),
         ("w2x.cunet.unet2", "bias_leaky_skip", 64),
         ("w2x.cunet.unet2", "bias", 3)])
    assert len(recs) == 1 + 2 + 2 + 4 + 10 + 12
