"""Whole runs on the CPU at a tiny size: the result line, the command's
refusals, and `correct` coming out false under the control and under each
fault the cells can have. Besides the configurations of the cells, a
noise-only one ("noise2", the stream's third mode) runs through the same
harness, and so does a second architecture ("toy": `toy.json`, its adapter
`toy_family.py` and its reference `toy_reference.py`), brought in files of
its own."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

GROUPS = [{"h": 24, "w": 32, "per_dispatch": 2, "frames": 4,
           "check_per_group": 2},
          {"h": 20, "w": 28, "per_dispatch": 2, "frames": 2,
           "check_per_group": 1}]
SEED = 2 ** 31 + 77
CONFIGS = ["scale2x", "noise2_scale2x", "noise2", "toy"]
TOY = dict(harness.read_json(harness.BENCH / "tests" / "toy.json"),
           name="toy")


@pytest.fixture(autouse=True, scope="module")
def noise_only_config():
    """harness.config also knows "noise2": the noise2 model alone, in the
    stream's noise mode (a bf16 stack, StreamConverter.from_params); and
    "toy", a configuration of another architecture than the cells'."""
    chain = harness.config("noise2_scale2x")
    extra = {"noise2": dict(chain, name="noise2", mode="noise",
                            stacks=[dict(chain["stacks"][0],
                                         dtype="bfloat16")]),
             "toy": TOY}
    read = harness.config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "config",
                   lambda name: extra[name] if name in extra else read(name))
        yield


def tiny(config, groups=GROUPS, **limits):
    lim = {"row_psnr_min_db": 45.0}
    if config == "noise2_scale2x":
        lim["noise_y_maxabs"] = 1e-4
    lim.update(limits)
    return {"name": f"tiny.{config}", "config": config, "chips": 1,
            "depth": 2, "env": {}, "groups": groups, "limits": lim}


def run(wl, trace=False, step_wrap=None, seed=SEED):
    return harness.run_cell(wl, seed, 0.05, trace, "cpu",
                            time.perf_counter(), step_wrap=step_wrap,
                            log=lambda line: None)


@pytest.fixture(scope="module", params=CONFIGS)
def sound(request):
    return request.param, run(tiny(request.param))


def test_sound_runs_are_correct(sound):
    _, result = sound
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 3


def test_the_result_line(sound):
    config, result = sound
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    json.loads(json.dumps(result, allow_nan=False))
    dev = result["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = ["frame_psnr_min_db", "row_psnr_min_db"]
    if config == "noise2_scale2x":
        names.append("noise_y_maxabs")
    assert list(result["checks"]) == names
    for row in result["checks"].values():
        assert set(row) == {"value", "limit"}


def test_a_traced_result_line():
    result = run(tiny("scale2x"), trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())


def test_the_same_seed_gives_the_same_frames_and_order():
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, False))
    wl = tiny("scale2x")
    a = harness.Traffic(wl, SEED, "cpu", gen)
    b = harness.Traffic(wl, SEED, "cpu", gen)
    c = harness.Traffic(wl, SEED + 1, "cpu", gen)
    assert all(torch.equal(x.host, y.host)
               for x, y in zip(a.batches, b.batches))
    assert a.checked == b.checked
    assert [a.next_pass() for _ in range(3)] == [b.next_pass()
                                                 for _ in range(3)]
    assert not torch.equal(a.batches[0].host, c.batches[0].host)
    assert [(x.n, x.h, x.w) for x in a.batches] == [(x.n, x.h, x.w)
                                                    for x in c.batches]


def unchanged(step):
    """The step leaves its result as it was: never written."""
    def f(yuv):
        out, y = step(yuv)
        return torch.zeros_like(out), y
    return f


def half(step):
    """Half of the batch converted, the rest filled from that half."""
    def f(yuv):
        k = max(1, yuv.shape[0] // 2)
        out, y = step(yuv[:k])
        idx = torch.arange(yuv.shape[0]) % k
        return out[idx], None if y is None else y[idx]
    return f


def altered(step):
    """One frame of the batch altered where it is produced: one level."""
    def f(yuv):
        out, y = step(yuv)
        out = out.clone()
        out[-1] = torch.clamp(out[-1].to(torch.int16) + 1, 0, 255).to(
            torch.uint8)
        return out, y
    return f


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
def test_each_fault_is_not_correct(config, fault):
    result = run(tiny(config), step_wrap=fault)
    assert not result["correct"] and result["failed"] >= 1


def test_the_toy_adapter_on_weights_of_another_seed_is_not_correct(
        monkeypatch):
    """The adapter draws its own weights from the next seed, not the ones
    the reference made for it: a fault the harness alone must catch."""
    family = harness.load_module(TOY["program"])
    ref = harness.load_module(TOY["reference"])
    build = family.build

    def own_weights(cfg, weights, device):
        other = dict(cfg["stacks"][0], seed=cfg["stacks"][0]["seed"] + 1)
        return build(cfg, {"sr": ref.weights(other, harness.ROOT, device)},
                     device)

    assert run(tiny("toy"))["correct"]
    monkeypatch.setattr(family, "build", own_weights)
    result = run(tiny("toy"))
    assert not result["correct"] and result["failed"] >= 1
    assert result["checks"]["frame_psnr_min_db"]["value"] < 40.0


def test_the_toy_counts_its_own_operations():
    """The window's calls are the adapter's, each with its own flops()."""
    wl = tiny("toy")
    cfg = harness.config("toy")
    prog = harness.program(cfg, "cpu")
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, False))
    traffic = harness.Traffic(wl, SEED, "cpu", gen)
    (call,) = prog.calls(traffic.batches[0])
    assert call.flops() == 2 * 9 * (3 * 8 + 8 * 12) * 2 * 24 * 32
    assert prog.out_px(traffic.batches[0]) == 2 * 48 * 64


@pytest.mark.parametrize("path", [
    "waifu2x_torch/pipeline.py", "benchmark/../waifu2x_torch/pipeline.py",
    "benchmark/configs/scale2x.json", "/benchmark/run.py"])
def test_modules_load_from_the_benchmark_alone(path):
    with pytest.raises(ValueError):
        harness.load_module(path)


SWEEP = "scale2x.sweep_720_4k"


def banded(limit):
    """A workload of 80-row frames, each converted in two bands once
    BAND_PX is cut to 64 low-res rows of 16, checked at `limit`."""
    groups = [{"h": 80, "w": 16, "per_dispatch": 1, "frames": 2,
               "check_per_group": 2}]
    return tiny("scale2x", groups, row_psnr_min_db=limit)


def test_bands_are_checked(monkeypatch):
    """Banded dispatches come out correct at the sweep cell's limit, and a
    band whose kept rows start one low-res row off does not."""
    from waifu2x_torch import pipeline
    limit = harness.workload(SWEEP)["limits"]["row_psnr_min_db"]
    monkeypatch.setattr(pipeline, "BAND_PX", 64 * 16)
    assert len(list(pipeline._bands(80, 64))) == 2
    assert run(banded(limit))["correct"]
    bands = pipeline._bands

    def off_by_one(h, rows, halo=pipeline._BAND_HALO, align=1):
        for s, size, lo, n in bands(h, rows, halo, align):
            yield s, size, max(0, lo - 1) if s else lo, n

    monkeypatch.setattr(pipeline, "_bands", off_by_one)
    assert not run(banded(limit))["correct"]


def test_a_band_without_its_halo_is_not_correct(monkeypatch):
    """The seams fault of `readings.py --faults seams`: every band run
    without its halo rows, so the rows at a seam see the band's edge
    replicated; the sweep cell's limit on row_psnr_min_db catches it."""
    from waifu2x_torch import pipeline
    limit = harness.workload(SWEEP)["limits"]["row_psnr_min_db"]
    monkeypatch.setattr(pipeline, "BAND_PX", 64 * 16)
    bands = pipeline._bands
    monkeypatch.setattr(pipeline, "_bands",
                        lambda h, rows, halo=0, align=1:
                        bands(h, rows, 0, align))
    result = run(banded(limit))
    assert not result["correct"] and result["failed"] >= 1
    assert result["checks"]["row_psnr_min_db"]["value"] < limit
    assert result["checks"]["frame_psnr_min_db"]["value"] > 45.0


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_is_not_correct(config):
    wl = tiny(config)
    cfg = harness.config(config)
    gen = (lambda s, n, h, w, d: harness.image_like(s, n, h, w, d, False))
    traffic = harness.Traffic(wl, SEED, "cpu", gen)
    got = harness.control_outputs(cfg, traffic, "cpu")
    nums, failed = harness.check(cfg, wl, traffic, got, "cpu")
    assert not nums.ok() and failed == len(traffic.checked)
    assert nums.values["frame_psnr_min_db"] < cfg["fidelity_db"]
    ref = dict(harness.reference_outputs(cfg, traffic, "cpu",
                                         traffic.checked))
    nums, failed = harness.check(cfg, wl, traffic, ref, "cpu")
    assert nums.ok() and failed == 0


def command(root, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=root, capture_output=True, text=True, env=env,
                          timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = command(harness.ROOT, "--workload", "scale2x.b16_512", "--seed",
                "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_the_command_refuses_beside_no_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path, "--workload", "scale2x.b16_512", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""
