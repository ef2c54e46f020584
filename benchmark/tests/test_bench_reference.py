"""The plain reference against independent computations at tiny sizes."""

import numpy as np
import pytest
import torch

from benchmark.harness import ROOT
from benchmark.reference import vgg7

SCALE = str(ROOT / "models" / "scale2.0x_demo.json")
NOISE = str(ROOT / "models" / "noise2_demo.json")


def numpy_stack(plane, layers):
    """Edge-replicate by 7, then each 3x3 layer as a sum over its taps
    (correlation), bias, LeakyReLU(0.1): float64 loops over the taps."""
    x = np.pad(plane.astype(np.float64), 7, mode="edge")[None]
    for w, b in layers:
        w, b = w.numpy().astype(np.float64), b.numpy().astype(np.float64)
        h, wd = x.shape[1] - 2, x.shape[2] - 2
        y = np.zeros((w.shape[0], h, wd))
        for dy in range(3):
            for dx in range(3):
                y += np.einsum("oi,ihw->ohw", w[:, :, dy, dx],
                               x[:, dy:dy + h, dx:dx + wd])
        y += b[:, None, None]
        x = np.where(y < 0, 0.1 * y, y)
    return x[0]


def random_layers(widths, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn((co, ci, 3, 3), generator=g) * (0.5 / ci) ** 0.5,
             torch.randn((co,), generator=g) * 0.05)
            for ci, co in zip(widths[:-1], widths[1:])]


def test_stack_against_numpy_loops():
    layers = random_layers([1, 4, 6, 5, 3, 4, 2, 1], 0)
    plane = np.random.default_rng(1).random((2, 11, 13), dtype=np.float32)
    got = vgg7.run_stack(torch.from_numpy(plane), layers).numpy()
    want = np.stack([numpy_stack(p, layers) for p in plane])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)   # f32 sums


def test_blocks_of_rows_change_nothing(monkeypatch):
    layers = random_layers([1, 3, 3, 3, 3, 3, 3, 1], 2)
    plane = torch.rand((1, 40, 9), generator=torch.Generator().manual_seed(3))
    whole = vgg7.run_stack(plane, layers)
    monkeypatch.setattr(vgg7, "BLOCK_PX", 9 * 16)   # blocks of 16 rows
    assert torch.equal(vgg7.run_stack(plane, layers), whole)


def test_parser_matches_the_ports_loader():
    from waifu2x_torch.models.weights import load_model_json
    for path in (SCALE, NOISE):
        ours = vgg7.load_model(path)
        port = load_model_json(path)
        assert len(ours) == len(port) == 7
        for (w, b), p in zip(ours, port):
            assert torch.equal(w.permute(2, 3, 1, 0), p["w"])
            assert torch.equal(b, p["b"])


def test_cubic_against_the_ports_opencv_resize():
    from waifu2x_torch.ops.resize import CUBIC, resize
    x = torch.rand((2, 7, 10), generator=torch.Generator().manual_seed(4))
    got = vgg7.cubic2x(x)
    want = resize(x, (14, 20), CUBIC, h_axis=1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_cubic_by_hand():
    # destination 5 samples 2.25: Keys' weights at t = 0.25, A = -0.75, are
    # (-0.10546875, 0.87890625, 0.26171875, -0.03515625) on rows 1..4;
    # destination 4 samples 1.75, the same weights reversed on rows 0..3
    x = torch.arange(12, dtype=torch.float32).repeat(3, 1)[None]
    got = vgg7.cubic2x(x)[0, 1]
    assert got[5].item() == pytest.approx(2.296875, abs=1e-6)
    assert got[4].item() == pytest.approx(1.703125, abs=1e-6)
    flat = torch.full((1, 5, 6), 0.375)
    assert torch.equal(vgg7.cubic2x(flat), torch.full((1, 10, 12), 0.375))


def test_colour_round_trip():
    x = torch.randint(0, 256, (64, 64, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(vgg7.to_u8(vgg7.to_yuv(x)), x)


def test_colour_against_the_ports():
    from waifu2x_torch.ops.color import bgr_to_yuv, u8_to_unit_f32
    x = torch.randint(0, 256, (16, 16, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(vgg7.to_yuv(x), bgr_to_yuv(u8_to_unit_f32(x)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["scale", "noise", "noise_scale"])
def test_conversion_against_the_ports_f32_path(mode):
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.pipeline import convert_image
    img = np.random.default_rng(7).integers(0, 256, (18, 22, 3), np.uint8)
    cfg = Config(mode=mode, noise_level=2, use_pallas=False,
                 compute_dtype="float32", block_size=0)
    port = convert_image(img, cfg, load_model_json(NOISE),
                         load_model_json(SCALE), device="cpu")
    noise = vgg7.load_model(NOISE) if "noise" in mode else None
    scale = vgg7.load_model(SCALE) if "scale" in mode else None
    ours, _ = vgg7.convert(torch.from_numpy(img)[None], scale, noise)
    assert ours.shape[1:] == port.shape
    diff = np.abs(ours[0].numpy().astype(int) - port.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12])
    assert vgg7.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10,
                                           1.0 + 2 ** -10, 1.0]


def test_the_controls_fall_below_the_reference():
    img = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (1, 16, 16, 3), np.uint8))
    layers = vgg7.load_model(SCALE)
    ref, _ = vgg7.convert(img, layers)
    for prec, most in (("fp8", 45.0), ("tf32", 80.0)):
        low, _ = vgg7.convert(img, layers, precisions={"scale": prec})
        mse = ((low.double() - ref.double()) ** 2).mean().item()
        assert mse > 0
        assert 10 * np.log10(255 ** 2 / mse) < most


def test_weights_are_held_to_their_digest(tmp_path):
    stack = {"role": "scale", "model": "models/scale2.0x_demo.json",
             "sha256": "749580353f0bbc6025c00a4f8d664df7c90cec8cc2ec89cbc815"
                       "c6d7d1bce26a", "dtype": "bfloat16"}
    got = vgg7.weights(stack, ROOT)
    assert all(torch.equal(w, v) and torch.equal(b, c) for (w, b), (v, c)
               in zip(got, vgg7.load_model(SCALE)))
    (tmp_path / "models").mkdir()
    doc = (ROOT / stack["model"]).read_bytes()
    (tmp_path / stack["model"]).write_bytes(doc.replace(b"]", b" ]", 1))
    with pytest.raises(RuntimeError, match="sha256"):
        vgg7.weights(stack, tmp_path)


def test_convert_by_role_is_convert():
    img = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (1, 10, 12, 3), np.uint8))
    scale, noise = vgg7.load_model(SCALE), vgg7.load_model(NOISE)
    for layers, args in (({"scale": scale}, (scale, None)),
                         ({"noise": noise}, (None, noise)),
                         ({"scale": scale, "noise": noise}, (scale, noise))):
        got, y = vgg7.convert_by_role(img, layers, {"scale": "fp8"})
        want, y_want = vgg7.convert(img, *args, {"scale": "fp8"})
        assert torch.equal(got, want)
        assert (y is None) == (y_want is None)
        assert y is None or torch.equal(y, y_want)
