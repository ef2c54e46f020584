"""Each metric's reader on a small canned run and trace."""

import pytest
import torch

from benchmark import harness, trace
from benchmark.counts import StackCall

MMA = "void conv3x3_bias_leaky_mma<32, 64, 32, 2>(__nv_bfloat16 const*, int)"
TF32 = "void conv3x3_bias_leaky_tf32<64, 64>(float const*, int)"
L1 = ("void (anonymous namespace)::l1_conv<__nv_bfloat16, false>("
      "__nv_bfloat16 const*, int)")
L7 = "void l7_fold<0, 0>(CUtensorMap, L7Args<__nv_bfloat16>)"
L7F = "void l7_fold_f32<0>(CUtensorMap, L7Args<float>)"
ELT = "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"
H2D = "Memcpy HtoD (Pinned -> Device)"
KERNELS = frozenset({"conv3x3_bias_leaky_mma", "conv3x3_bias_leaky_tf32",
                     "l1_conv", "l7_fold", "l7_fold_f32"})
SCALE = StackCall("scale", "bfloat16", 16, 512, 512)
NOISE = StackCall("noise", "float32", 4, 1080, 1920)


def canned(calls=None, device=None, **kw):
    device = device if device is not None else [
        (H2D, 0.0, 0.5), (L1, 0.5, 1.0), (MMA, 1.0, 3.0), (MMA, 3.0, 5.0),
        (L7, 5.0, 5.5), (ELT, 5.5, 6.0), (ELT, 8.0, 9.0)]
    tr = trace.Trace(10.0, device, [("bench.step", 6.0, 8.0),
                                    ("bench.wait", 9.0, 10.0)],
                     [("aten::cat", 6.5, 7.5), ("aten::copy_", 6.6, 6.7)])
    args = dict(cell="c", config={}, workload={"env": {}}, setup_s=12.5,
                window_s=10.0, dispatches=4, out_px=4 * SCALE.out_px(),
                latency_ms=[float(v) for v in range(1, 101)],
                calls={SCALE: 4}, counters={"stack.LAUNCHES": 28},
                peak_mem_bytes=9_876_543_210, trace=tr, kernels=KERNELS)
    args.update(kw)
    if calls is not None:
        args["calls"] = calls
    return harness.Run(**args)


def read(name, run):
    return harness.load_reader(name)(run)


def test_end_to_end_readers():
    run = canned()
    assert read("out_mp_per_s", run) == pytest.approx(
        4 * 16 * 1024 * 1024 / 1e6 / 10.0)
    assert read("batch_ms_p95", run) == pytest.approx(95.05)
    assert read("setup_s", run) == 12.5


SIZES = {"720p": (720, 1280), "1080p": (1080, 1920), "1440p": (1440, 2560),
         "2160p": (2160, 3840)}


@pytest.mark.parametrize("k, tag", enumerate(SIZES))
def test_per_size_latency_readers(k, tag):
    """Dispatch i of 100 (latency i + 1 ms) has size i % 4: each reader
    takes the percentile over its own 25 alone."""
    sizes = [SIZES[list(SIZES)[i % 4]] for i in range(100)]
    run = canned(sizes=sizes)
    own = [float(i + 1) for i in range(k, 100, 4)]
    want = own[22] + 0.8 * (own[23] - own[22])   # numpy's linear 95th
    assert read(f"batch_ms_p95.{tag}", run) == pytest.approx(want)
    assert read(f"batch_ms_p95.{tag}", canned(sizes=[(1, 1)] * 100)) is None


def test_mfu():
    # 4 batches of 9.6346 TFLOP at 989 TFLOP/s over 10 s
    want = 100 * 4 * SCALE.out_px() * 574272 / 989e12 / 10.0
    assert read("pipeline.mfu", canned()) == pytest.approx(want)
    both = canned(calls={SCALE: 1, NOISE: 1})
    want = 100 * (SCALE.out_px() * 574272 / 989e12
                  + NOISE.out_px() * 574272 / 495e12) / 10.0
    assert read("pipeline.mfu", both) == pytest.approx(want)


def test_mfu_of_another_architectures_calls():
    """A call of the toy architecture counts its own operations."""
    toy = harness.load_module("benchmark/tests/toy_family.py")
    call = toy.ToyCall("bfloat16", 4, 24, 32)
    want = 100 * 3 * call.flops() / 989e12 / 10.0
    assert read("pipeline.mfu", canned(calls={call: 3})) == pytest.approx(
        want)
    mixed = canned(calls={SCALE: 1, toy.ToyCall("float32", 1, 8, 8): 2})
    assert read("pipeline.mfu", mixed) == pytest.approx(
        100 * (SCALE.flops() / 989e12
               + 2 * 2 * 9 * 120 * 64 / 495e12) / 10.0)


def test_nonstack_and_idle():
    run = canned()
    # the copy 0.5 s, the two PyTorch kernels 1.5 s: 2 s over 67.1 MP
    mp = 4 * SCALE.out_px() / 1e6
    assert read("pipeline.nonstack_ms_per_mp", run) == pytest.approx(
        2e3 / mp)
    # busy 0-6 and 8-9: 7 of 10 s
    assert read("device.idle_pct", run) == pytest.approx(30.0)
    assert run.trace.busy() == [(0.0, 6.0), (8.0, 9.0)]


def test_idle_gaps_name_the_host():
    gaps = canned().trace.idle_gaps()
    assert gaps == [["bench.step: aten::cat", pytest.approx(2.0)],
                    ["bench.wait: python", pytest.approx(1.0)]]


def test_counters_and_memory():
    assert read("stack.launches_per_batch", canned()) == 7.0
    assert read("device.peak_mem_gb", canned()) == pytest.approx(9.87654321)


def test_kernel_rooflines():
    run = canned()
    l1_bytes = 2 * (16 * 512 * 512 + 16 * 32 * 1036 * 1036)
    want = 100 * 4 * max(SCALE.layer_ops(1) / 989e12,
                         l1_bytes / 3.35e12) / 0.5
    assert read("kern.l1_roofline", run) == pytest.approx(want)
    mid = sum(SCALE.bound_s(SCALE.layer_ops(k), SCALE.layer_bytes(k))
              for k in range(2, 7))
    assert read("kern.mma_roofline", run) == pytest.approx(
        100 * 4 * mid / 4.0)
    l7_bytes = 2 * (16 * 128 * 1026 * 1026 + 16 * 512 * 512 * 4)
    assert read("kern.l7_roofline", run) == pytest.approx(
        100 * 4 * l7_bytes / 3.35e12 / 0.5)


def test_tf32_roofline_reads_f32_calls_only():
    run = canned(calls={SCALE: 1, NOISE: 2},
                 device=[(TF32, 0.0, 2.0), (L7F, 2.0, 2.5), (MMA, 3.0, 4.0)])
    mid = sum(NOISE.bound_s(NOISE.layer_ops(k), NOISE.layer_bytes(k))
              for k in range(2, 7))
    assert read("kern.mma_tf32_roofline", run) == pytest.approx(
        100 * 2 * mid / 2.0)


@pytest.mark.parametrize("name", [
    "pipeline.nonstack_ms_per_mp", "kern.l1_roofline", "kern.mma_roofline",
    "kern.mma_tf32_roofline", "kern.l7_roofline", "device.idle_pct"])
def test_readers_with_nothing_to_read(name):
    assert read(name, canned(trace=None)) is None
    if name != "device.idle_pct" and name != "pipeline.nonstack_ms_per_mp":
        empty = canned(device=[(ELT, 0.0, 1.0)])
        assert read(name, empty) is None


def test_read_metrics_keeps_the_manifest_order_and_drops_none():
    entries = [{"name": "kern.mma_tf32_roofline", "unit": "%"},
               {"name": "device.idle_pct", "unit": "%"},
               {"name": "setup_s", "unit": "s", "workloads": ["other"]}]
    out = harness.read_metrics(canned(), entries)
    assert list(out) == ["device.idle_pct"]
    assert out["device.idle_pct"]["unit"] == "%"


def test_trace_from_a_cpu_profile():
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            for _ in range(3):
                with torch.profiler.record_function("bench.step"):
                    x = torch.tanh(x @ x)
    tr = trace.from_profiler(prof)
    assert tr.window_s > 0 and tr.device == []
    assert [s[0] for s in tr.spans] == ["bench.step"] * 3
    assert all(0 <= s <= e <= tr.window_s for _, s, e in tr.spans + tr.ops)
    assert any(name == "aten::tanh" for name, _, _ in tr.ops)


def test_program_kernel_names():
    names = trace.program_kernels(harness.ROOT / "waifu2x_torch" / "csrc")
    assert KERNELS <= names
    assert trace.base_name(MMA) == "conv3x3_bias_leaky_mma"
    assert trace.base_name(ELT) == "vectorized_elementwise_kernel"
    assert trace.base_name(L1) == "l1_conv"
