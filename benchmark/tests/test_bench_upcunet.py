"""The UpCUNet configuration (configs/upcunet2x.json, families/upcunet.py,
reference/upcunet.py, cunet_counts.py) through the harness on the CPU at a
tiny tile (76 input pixels a side, 80 out): correct, and not under its fp8
control, the generic faults, or the two planted faults of its own (each
SE block's means over the whole batch, tiles cut with no halo); its
counts and readers; and the manifest's two new cells and five metrics,
beside entries that are as they were."""

import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import cunet_counts, harness, trace
from benchmark.counts import PEAK_FLOPS

SEED = 2 ** 31 + 91
CELL = "upcunet2x.b4_1080"
GROUPS = [{"h": 80, "w": 120, "per_dispatch": 2, "frames": 4,
           "check_per_group": 2}]


@pytest.fixture(autouse=True, scope="module")
def tiny_tile():
    """upcunet2x at a 76-pixel tile, the rest of its configuration as it
    is."""
    cfg = harness.config("upcunet2x")
    cfg["stacks"] = [dict(cfg["stacks"][0], tile=76)]
    read = harness.config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "config",
                   lambda name: cfg if name == "upcunet2x" else read(name))
        yield cfg


def tiny():
    wl = harness.workload(CELL)
    return dict(wl, name="tiny.upcunet2x", groups=GROUPS)


def run(wl, trace_on=False, step_wrap=None):
    return harness.run_cell(wl, SEED, 0.05, trace_on, "cpu",
                            time.perf_counter(), step_wrap=step_wrap,
                            log=lambda line: None)


def test_a_sound_run_is_correct():
    result = run(tiny())
    assert result["correct"] and result["failed"] == 0
    assert list(result["checks"]) == ["frame_psnr_min_db", "row_psnr_min_db"]
    assert set(result["metrics"]) == {"out_mp_per_s", "setup_s"}


def test_the_control_is_not_correct(tiny_tile):
    wl = tiny()
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, False))
    traffic = harness.Traffic(wl, SEED, "cpu", gen)
    assert harness.control_precisions(tiny_tile) == {"upcunet": "fp8"}
    got = harness.control_outputs(tiny_tile, traffic, "cpu")
    nums, failed = harness.check(tiny_tile, wl, traffic, got, "cpu")
    assert not nums.ok() and failed == len(traffic.checked)
    assert nums.values["frame_psnr_min_db"] < tiny_tile["fidelity_db"]


def altered(step):
    """One frame of the batch eight levels off where it is produced."""
    def f(x):
        out, aux = step(x)
        out = out.clone()
        out[-1] = torch.clamp(out[-1].to(torch.int16) + 8, 0,
                              255).to(torch.uint8)
        return out, aux
    return f


def half(step):
    """Half of the batch converted, the rest filled from that half."""
    def f(x):
        out, aux = step(x[:1])
        return out[[0] * x.shape[0]], aux
    return f


@pytest.mark.parametrize("fault", [altered, half], ids=lambda f: f.__name__)
def test_generic_faults_are_not_correct(fault):
    result = run(tiny(), step_wrap=fault)
    assert not result["correct"] and result["failed"] >= 1


def se_over_the_batch(x, model, key):
    w1, b1, w2, b2 = model.se[key]
    z = torch.mean(x, dim=(0, 1, 2), dtype=torch.float32)
    z = torch.sigmoid(torch.relu(z @ w1 + b1) @ w2 + b2)
    return torch.mul(x, z.expand(x.shape[0], -1)[:, None, None, :],
                     out=torch.empty_like(x))


def tiles_without_halo(x, tile):
    n, h, w, c = x.shape
    step = tile - 2 * cunet_counts.HALO
    ny, nx = -(-h // step), -(-w // step)
    xp = F.pad(x.permute(0, 3, 1, 2), (0, nx * step - w, 0, ny * step - h),
               mode="replicate")
    b = xp.unfold(2, step, step).unfold(3, step, step)
    b = b.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, step, step)
    t = F.pad(b, (cunet_counts.HALO,) * 4, mode="replicate")
    return t.permute(0, 2, 3, 1).contiguous(), ny, nx


@pytest.mark.parametrize("fault", ["se", "halo"])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    from waifu2x_torch import pipeline
    from waifu2x_torch.ops import unet
    if fault == "se":
        monkeypatch.setattr(unet, "squeeze_excite", se_over_the_batch)
    else:
        monkeypatch.setattr(pipeline, "cunet_tiles", tiles_without_halo)
    result = run(tiny())
    assert not result["correct"] and result["failed"] >= 1
    row = result["checks"]["row_psnr_min_db"]
    assert row["value"] < row["limit"]


def test_the_parent_program_fails_at_once(monkeypatch):
    """A program without the UpCUNet step (the parent of the change that
    brings it) stops before any window, with an error."""
    import waifu2x_torch.pipeline as pipeline
    monkeypatch.delattr(pipeline, "upcunet2x_batch_u8")
    t = time.perf_counter()
    with pytest.raises(ImportError):
        run(tiny())
    assert time.perf_counter() - t < 30


def test_the_adapter_counts_every_tile():
    wl = tiny()
    cfg = harness.config("upcunet2x")
    prog = harness.program(cfg, "cpu")
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, False))
    batch = harness.Traffic(wl, SEED, "cpu", gen).batches[0]
    (call,) = prog.calls(batch)
    assert call.tiles == 2 * 2 * 3 and call.dtype == "bfloat16"
    per_tile = sum(cunet_counts.layer_macs(*l[1:])
                   for l in cunet_counts.layers(76))
    assert call.flops() == 2 * 12 * per_tile
    assert prog.out_px(batch) == 2 * 160 * 240
    assert prog.out_shape(batch) == (2, 160, 240, 3)


def test_counts_at_the_cells_size():
    """A 436-pixel tile: 1.298e11 MAC; a 1080p frame 15 tiles; the counts
    agree with the port's own model description; 69.6% of the MAC on
    csrc/mma.cu."""
    from waifu2x_torch.models import cunet
    layers = cunet_counts.layers(436)
    assert sum(cunet_counts.layer_macs(*l[1:]) for l in layers) == \
        cunet.tile_macs(436) == 129_784_309_504
    sides = cunet.layer_sides(436)
    assert {l[0]: (l[4], l[5]) for l in layers
            if l[1] not in ("s1", "s2")} == {
        k: v for k, v in sides.items() if cunet.BY_KEY[k].kind
        not in ("se1", "se2")}
    call = cunet_counts.CunetCall("bfloat16", 4, 1080, 1920, 436)
    assert call.tiles == 60
    assert call.flops() / PEAK_FLOPS["bfloat16"] == pytest.approx(
        0.015748, rel=1e-3)
    mma = sum(cunet_counts.layer_macs(*l[1:]) for l in layers
              if l[1] == "c3" and (l[2], l[3]) in cunet_counts.MMA_WIDTHS)
    assert mma / cunet.tile_macs(436) == pytest.approx(0.696, abs=1e-3)
    assert 0 < call.mma_bound_s() < call.flops() / PEAK_FLOPS["bfloat16"]


MMA = "void conv3x3_bias_leaky_mma<128, 64, 16>(CUtensorMap, int)"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
ELT = "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"
H2D = "Memcpy HtoD (Pinned -> Device)"


def canned(**kw):
    call = cunet_counts.CunetCall("bfloat16", 4, 1080, 1920, 436)
    tr = trace.Trace(1.0, [(H2D, 0.0, 0.01), (MMA, 0.01, 0.21),
                           (CONV, 0.21, 0.51), (ELT, 0.51, 0.61)], [])
    args = dict(cell=CELL, config={}, workload={"env": {}}, setup_s=9.0,
                window_s=1.0, dispatches=8, out_px=8 * 4 * 2160 * 3840 // 4,
                latency_ms=[1.0], calls={call: 8},
                counters={"stack.LAUNCHES": 80}, peak_mem_bytes=1,
                trace=tr, kernels=frozenset({"conv3x3_bias_leaky_mma"}))
    args.update(kw)
    return harness.Run(**args)


def read(name, run_):
    return harness.load_reader(name)(run_)


def test_readers():
    r = canned()
    (call,) = r.calls
    assert read("pipeline.mfu", r) == pytest.approx(
        100 * 8 * call.flops() / 989e12)
    assert read("kern.mma_cunet_roofline", r) == pytest.approx(
        100 * 8 * call.mma_bound_s() / 0.2)
    mp = r.out_px / 1e6
    assert read("cunet.library_ms_per_mp", r) == pytest.approx(
        1e3 * 0.4 / mp)


@pytest.mark.parametrize("name", ["kern.mma_cunet_roofline",
                                  "cunet.library_ms_per_mp",
                                  "cunet.se_ms_per_mp",
                                  "cunet.tile_ms_per_mp"])
def test_readers_with_nothing_to_read(name, monkeypatch):
    from benchmark import spans
    monkeypatch.setattr(spans, "records", lambda: None)
    vgg = canned(calls={}, trace=None)
    assert read(name, vgg) is None


def test_span_readers(monkeypatch):
    from benchmark import spans

    class Rec:
        def __init__(self, name, ms):
            self.name, self.device_ms, self.host_ms = name, ms, ms
            self.id, self.parent = id(self), None

    recs = [Rec("w2x.cunet.se", 2.0), Rec("w2x.cunet.se", 1.0),
            Rec("w2x.cunet.tiles", 0.5), Rec("w2x.cunet_step", 9.0)]
    monkeypatch.setattr(spans, "records", lambda: recs)
    r = canned()
    mp = r.out_px / 1e6
    assert read("cunet.se_ms_per_mp", r) == pytest.approx(3.0 / mp)
    assert read("cunet.tile_ms_per_mp", r) == pytest.approx(0.5 / mp)


# -- the manifest ---------------------------------------------------------

MAN = harness.manifest()
NEW_METRICS = ["kern.mma_cunet_roofline",
               "cunet.library_ms_per_mp", "cunet.se_ms_per_mp",
               "cunet.tile_ms_per_mp"]
OLD_CELLS = ["scale2x.b16_512", "noise2_scale2x.b4_1080",
             "scale2x.sweep_720_4k"]


def test_the_new_cells_and_metrics():
    cells = [w["name"] for w in MAN["workloads"]]
    assert cells == OLD_CELLS + [CELL, "noise2_scale2x.b2_4k"]
    assert [c["name"] for c in MAN["configs"]] == [
        "scale2x", "noise2_scale2x", "upcunet2x"]
    per = {m["name"]: m for m in MAN["per_layer"]}
    assert [m["name"] for m in MAN["per_layer"]][-4:] == NEW_METRICS
    for name in NEW_METRICS:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "out_mp_per_s"
    assert per["kern.mma_cunet_roofline"]["unit"] == "%"
    cfg = harness.read_json(harness.BENCH / "configs" / "upcunet2x.json")
    assert cfg["reduced"] == [] and cfg["stacks"][0]["tile"] == 436


# the accepted metrics that read UpCUNet's cell too: the whole step's share
# of the peak, the device's idle share and peak memory, the weights' set-up
SHARED = ["pipeline.mfu", "device.idle_pct", "device.peak_mem_gb",
          "setup.prep_s"]


def test_existing_entries_are_as_they_were():
    """The three cells' entries, their metrics and bounds: a metric's cells
    at most gain the new cells, appended (the 4K chain cell wherever the
    1080p chain cell is listed; UpCUNet's cell in SHARED and in
    batch_ms_p95); every bound is as it was."""
    e2e = {m["name"]: (m["bound"], m.get("workloads")) for m in
           MAN["end_to_end"]}
    assert e2e == {
        "out_mp_per_s": (0.01, None),
        "batch_ms_p95": (0.01, ["scale2x.b16_512", "noise2_scale2x.b4_1080",
                                CELL]),
        "batch_ms_p95.720p": (0.014, ["scale2x.sweep_720_4k"]),
        "batch_ms_p95.1080p": (0.015, ["scale2x.sweep_720_4k"]),
        "batch_ms_p95.1440p": (0.015, ["scale2x.sweep_720_4k"]),
        "batch_ms_p95.2160p": (0.015, ["scale2x.sweep_720_4k"]),
        "setup_s": (0.25, None)}
    for m in MAN["per_layer"]:
        if m["name"] in NEW_METRICS:
            continue
        old = [c for c in m["workloads"] if c in OLD_CELLS]
        assert m["workloads"] == old + (["noise2_scale2x.b2_4k"] if
                                        "noise2_scale2x.b4_1080" in old
                                        else []) + (
            [CELL] if m["name"] in SHARED else [])


@pytest.mark.parametrize("name", SHARED)
def test_the_cell_reports_the_shared_metrics(name):
    """UpCUNet's cell lists the accepted metrics whose code reads it:
    pipeline.mfu from the adapter's calls, the device's two from the run,
    setup.prep_s from CunetModel.build's "w2x.setup.prep" span."""
    from waifu2x_torch.utils import trace as spans_of_the_port
    per = {m["name"]: m for m in MAN["per_layer"]}
    assert per[name]["workloads"][-1] == CELL
    spans_of_the_port.reset()
    harness.program(harness.config("upcunet2x"), "cpu")
    r = canned(trace=trace.Trace(1.0, [(MMA, 0.0, 0.5)], []),
               peak_mem_bytes=20_000_000_000)
    try:
        assert read(name, r) > 0
    finally:
        spans_of_the_port.reset()
