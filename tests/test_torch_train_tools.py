"""The port's training tool and its three fidelity tools on the CPU:
waifu2x_torch/tools/train_demo.py's synthetic images and held-out set bit
for bit against the JAX package's tools/train_demo.py, a small run of it
end to end (export, reload, provenance), and chain_fidelity_probe,
edge_error_probe and ns1080_probe on the kernels' plain versions at 32 px
or less."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.tools import (
    chain_fidelity_probe,
    edge_error_probe,
    ns1080_probe,
    train_demo,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jdemo():
    spec = importlib.util.spec_from_file_location(
        "jax_train_demo", ROOT / "tools" / "train_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gen", ["v1", "v2"])
def test_synth_image_bit_equal(jdemo, gen):
    for seed in range(4):
        got = train_demo.synth_image(np.random.default_rng(seed), 64, gen)
        want = jdemo.synth_image(np.random.default_rng(seed), 64, gen)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,level,gen", [("scale", 1, "v1"),
                                            ("noise", 2, "v1"),
                                            ("scale", 1, "v2")])
def test_build_eval_set_bit_equal(jdemo, kind, level, gen):
    assert train_demo.EVAL_SEED == jdemo.EVAL_SEED == 777
    got = train_demo.build_eval_set(kind, level, n_images=2, crops_per=2,
                                    crop=32, gen=gen)
    want = jdemo.build_eval_set(kind, level, n_images=2, crops_per=2,
                                crop=32, gen=gen)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4,) + g.shape[1:]
        np.testing.assert_array_equal(g, w)
    assert (train_demo.input_baseline_db(*got)
            == jdemo.input_baseline_db(*want))


def test_train_demo_runs_end_to_end(tmp_path, capsys):
    """A narrow 7-layer model (--widths), warmup, clipping, EMA and the QAT
    loss for 4 steps: the best evaluated weights exported, reloaded, and
    described in the sidecar."""
    out = tmp_path / "m.json"
    argv = ["--device", "cpu", "--widths", "1,4,4,4,4,4,4,1", "--steps", "4",
            "--batch", "2", "--crop", "32", "--images", "2", "--imgsize",
            "64", "--ema", "0.9", "--clip", "1", "--warmup", "1",
            "--eval_every", "2", "--workers", "2", "--qat_mu", "4",
            "--out", str(out)]
    assert train_demo.main(argv) == 0
    text = capsys.readouterr().out
    assert "held-out baselines: input" in text and "reloads cleanly" in text
    params = load_model_json(out)
    assert [int(p["w"].shape[3]) for p in params] == [4] * 6 + [1]
    prov = json.loads(Path(str(out) + ".provenance.json").read_text())
    assert prov["script"] == "waifu2x_torch/tools/train_demo.py"
    assert prov["qat_mu"] == 4.0 and prov["steps"] == 4
    assert [(p["step"], p["variant"]) for p in prov["curve"]] == [
        (2, "sgd"), (2, "ema"), (4, "sgd"), (4, "ema")]
    assert all("l6_quant_gap_db" in p for p in prov["curve"])
    assert prov["heldout_y_psnr_db"] >= prov["heldout_y_psnr_untrained_db"]
    with pytest.raises(SystemExit):
        train_demo.main(argv + ["--init", str(out)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_tools_default_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_demo.main(["--out", "unused.json"])
    for tool in (chain_fidelity_probe, edge_error_probe, ns1080_probe):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main([])


def test_chain_fidelity_probe_plain(capsys):
    results = []
    assert chain_fidelity_probe.main(["--device", "cpu", "--size", "24"],
                                     results) == 0
    dbs = results[0]
    assert list(dbs) == ["bf/bf", "f32/bf", "bf/f32", "f32/f32"]
    # the f32 chain's plain versions are the non-kernel path's arithmetic
    assert dbs["f32/f32"] >= 50.0
    assert all(db > 40.0 for db in dbs.values())
    assert dbs["f32/f32"] >= max(dbs["bf/bf"], dbs["f32/bf"])
    assert "f32/f32" in capsys.readouterr().out


def test_edge_error_probe_plain():
    results = []
    assert edge_error_probe.main(["--device", "cpu", "--size", "16"],
                                 results) == 0
    r = results[0]
    assert r["size"] == 32
    assert [b[:2] for b in r["bins"]] == [(0, 1), (1, 2), (2, 4), (4, 8),
                                          (8, 16)]
    assert sorted(r["border_psnr"]) == [0, 2, 4, 8]
    assert r["psnr"] > 40.0 and r["border_psnr"][0] == r["psnr"]


def test_ns1080_probe_plain_and_its_bands():
    results = []
    only = "noise-only nb=1024 (2 bands),chain b6 nb1024 sb540"
    assert ns1080_probe.main(["--device", "cpu", "--size", "24x40",
                              "--iters", "1", "--only", only], results) == 0
    assert [r["name"] for r in results] == only.split(",")
    assert results[1]["batch"] == 6 and results[1]["ms"] > 0
    # at 1080 x 1920 the BAND_PX cap leaves the JAX tool's band counts,
    # batch 8's scale step included
    from waifu2x_torch.pipeline import _band_rows, _noise_band_rows
    for rows, bands in ((_noise_band_rows(1024, 4, 1920), 2),
                        (_noise_band_rows(2304, 4, 1920), 1),
                        (_band_rows(512, 4, 1920), 3),
                        (_band_rows(540, 4, 1920), 2),
                        (_band_rows(1152, 4, 1920), 1),
                        (_band_rows(540, 8, 1920), 2)):
        assert ns1080_probe.bands_run(1080, rows) == bands
