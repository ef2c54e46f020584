"""The port's block tiler (waifu2x_torch.parallel.tiles) against the JAX
package's and against the monolithic pass, on seeded numpy inputs (the
invariant of the reference's block splitter, appendix/hints-jp.md:47-49),
and the port's tiling decision (pipeline._convert_y) against the JAX
package's.

Bars: tiled against monolithic 1e-6 and against the literal block-split
oracle 1e-5 (the JAX suite's, tests/test_tiles.py); against JAX's
tiled_convert 3e-5 (two f32 convolution libraries); Converter outputs at
the u8 bar (|diff| <= 1 at < 0.2% of bytes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.config import Config as JConfig
from waifu2x_tpu.models import ModelSpec as JModelSpec
from waifu2x_tpu.models import init_params
from waifu2x_tpu.models.srcnn import as_numpy
from waifu2x_tpu.models.weights import save_model_json
from waifu2x_tpu.parallel import tiles as jtiles
from waifu2x_torch import pipeline as pl
from waifu2x_torch.config import Config
from waifu2x_torch.models.srcnn import SRCNN
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.parallel import tiles as ttiles
from tests import oracle

torch.set_num_threads(2)
SMALL = JModelSpec.from_widths([1, 4, 4, 1])  # offset 3


def _params(seed):
    return as_numpy(init_params(jax.random.PRNGKey(seed), SMALL))


def _model(params_np):
    return SRCNN.from_params(params_from_numpy(params_np))


@pytest.mark.parametrize("h,w,tile,offset", [
    (100, 200, 64, 7), (101, 201, 64, 7), (45, 83, 32, 3), (512, 512, 512, 7),
    (1080, 1920, 512, 7), (7, 5, 20, 3)])
def test_plan_equals_jax(h, w, tile, offset):
    got = ttiles.plan_tiles(h, w, tile, offset)
    want = jtiles.plan_tiles(h, w, tile, offset)
    for f in ("h", "w", "tile", "offset", "ny", "nx", "stride", "hp", "wp",
              "n_tiles", "redundancy"):
        assert getattr(got, f) == getattr(want, f), f


def test_plan_rejects_tile_within_halo():
    with pytest.raises(ValueError):
        ttiles.plan_tiles(10, 10, tile=14, offset=7)


def test_extract_stitch_roundtrip(rng):
    y = rng.random((45, 83), dtype=np.float32)
    plan = ttiles.plan_tiles(45, 83, tile=32, offset=3)
    tiles = ttiles.extract_tiles(torch.from_numpy(y), plan)
    assert tiles.shape == (plan.n_tiles, 32, 32)
    np.testing.assert_array_equal(
        tiles.numpy(),
        np.asarray(jtiles.extract_tiles(jnp.asarray(y),
                                        jtiles.plan_tiles(45, 83, 32, 3))))
    # stitching the tile interiors of the input reproduces the input
    k = plan.offset
    np.testing.assert_array_equal(
        ttiles.stitch_tiles(tiles[:, k:-k, k:-k], plan).numpy(), y)


@pytest.mark.parametrize("shape,tile", [((64, 64), 32), ((61, 77), 40)])
def test_tiled_equals_monolithic(rng, shape, tile):
    model = _model(_params(0))
    y = torch.from_numpy(rng.random(shape, dtype=np.float32))
    plan = ttiles.plan_tiles(*shape, tile=tile, offset=3)
    got = ttiles.tiled_convert(y, model, plan, batch_tiles=3)
    want = model.convert_plane(y[None])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_tiled_matches_blocksplit_oracle(rng):
    """The tiler against the literal port of convertWithModelsBlockSplit."""
    params_np = _params(1)
    y = rng.random((70, 90), dtype=np.float32)
    plan = ttiles.plan_tiles(70, 90, tile=32, offset=3)
    got = ttiles.tiled_convert(torch.from_numpy(y), _model(params_np), plan)
    want = oracle.convert_with_models_block_split(y, params_np, block_size=32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_batch_padding_harmless(rng):
    """n_tiles not divisible by batch_tiles must not corrupt output."""
    model = _model(_params(2))
    y = torch.from_numpy(rng.random((50, 50), dtype=np.float32))
    plan = ttiles.plan_tiles(50, 50, tile=20, offset=3)  # 16 tiles
    a = ttiles.tiled_convert(y, model, plan, batch_tiles=5)
    b = ttiles.tiled_convert(y, model, plan, batch_tiles=16)
    c = ttiles.tiled_convert(y, model, plan, batch_tiles=100)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b.numpy(), c.numpy())


@pytest.mark.parametrize("shape,tile,batch", [((70, 90), 32, 4),
                                              ((33, 129), 24, 8)])
def test_tiled_matches_jax_tiled_convert(rng, shape, tile, batch):
    params_np = _params(3)
    y = rng.random(shape, dtype=np.float32)
    got = ttiles.tiled_convert(torch.from_numpy(y), _model(params_np),
                               ttiles.plan_tiles(*shape, tile, 3), batch)
    want = jtiles.tiled_convert(jnp.asarray(y), params_np,
                                jtiles.plan_tiles(*shape, tile, 3),
                                batch_tiles=batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=0)


@pytest.mark.parametrize("h,w,bs,single", [
    (20, 30, 16, True),    # 600 > 384: tiles
    (19, 20, 16, True),    # 380 <= 384: monolithic
    (20, 20, 16, True),    # 400 > 384: tiles
    (20, 30, 0, True),     # block_size 0: never tiles
    (20, 30, 16, False),   # a batch: never tiles, as JAX's [N, H, W] calls
])
def test_convert_y_tiles_exactly_when_jax_does(rng, monkeypatch, h, w, bs,
                                               single):
    params_np = _params(4)
    calls = {"jax": 0, "torch": 0}

    def spy(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(jpl, "tiled_convert",
                        spy("jax", jtiles.tiled_convert))
    monkeypatch.setattr(pl, "tiled_convert",
                        spy("torch", ttiles.tiled_convert))
    y = rng.random((h, w), dtype=np.float32)
    jy = jnp.asarray(y) if single else jnp.asarray(y)[None]
    want = np.asarray(jpl._convert_y(
        jy, params_np, JConfig(block_size=bs, tile_size=16, batch_tiles=3)))
    got = pl._convert_y(torch.from_numpy(y)[None], _model(params_np),
                        Config(block_size=bs, tile_size=16, batch_tiles=3),
                        single=single)
    assert calls["torch"] == calls["jax"] == int(
        single and bs > 0 and h * w > bs * bs * 3 // 2)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=3e-5, rtol=0)


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


@pytest.mark.parametrize("mode", ["noise", "scale", "noise_scale"])
def test_converter_tiled_matches_jax(tmp_path, rng, monkeypatch, mode):
    """A Converter whose planes exceed 1.5 blocks tiles its noise phase and
    its scale step, in both packages, to the same u8 output."""
    for name, seed in (("noise1_model.json", 5),
                       ("scale2.0x_model.json", 6)):
        save_model_json(str(tmp_path / name), _params(seed))
    n_tiled = []
    monkeypatch.setattr(pl, "tiled_convert", lambda *a, **kw: (
        n_tiled.append(a[2].n_tiles), ttiles.tiled_convert(*a, **kw))[1])
    kw = dict(mode=mode, model_dir=str(tmp_path), block_size=16,
              tile_size=24, batch_tiles=4)
    img = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    ref = jpl.Converter.from_config(JConfig(
        use_pallas=False, **kw)).process_bgr_u8(img)
    got = pl.Converter.from_config(Config(**kw), device="cpu").process_bgr_u8(
        img)
    assert len(n_tiled) == (2 if mode == "noise_scale" else 1)
    _assert_u8_close(got, ref)
