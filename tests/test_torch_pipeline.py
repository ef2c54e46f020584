"""The port's scale path (waifu2x_torch.pipeline) on the CPU against the JAX
package's pipeline, on seeded numpy inputs.

Bars: u8 outputs equal except |diff| <= 1 on < 0.2% of pixels where the two
sides round the final u8 from f32 sums taken in another order; banding is
exact; scale_plan is identical."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.config import Config as JConfig
from waifu2x_tpu.models.srcnn import ModelSpec as JModelSpec
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.models.weights import save_model_json
from waifu2x_torch import pipeline as pl
from waifu2x_torch.config import Config
from waifu2x_torch.models.srcnn import SRCNN
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops.s2d import d2s_host
from waifu2x_torch.utils.metrics import psnr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(11), JFLAGSHIP))


@pytest.fixture(scope="module")
def fast32(params_np):
    return pl.FastStack.build(params_from_numpy(params_np), True,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def model_dir(params_np, tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    save_model_json(d / "scale2.0x_model.json", params_np)
    return str(d)


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


def test_scale2x_batch_u8_fused_matches_jax(params_np, fast32, rng):
    yuv = rng.random((2, 24, 40, 3), dtype=np.float32)
    jfast = jpl.FastStack.build(params_np, True, tile=(8, 16),
                                dtype=jnp.float32, interpret=True)
    ref = np.asarray(jpl.scale2x_batch_u8_fused(jnp.asarray(yuv), jfast))
    got = pl.scale2x_batch_u8_fused(torch.from_numpy(yuv), fast32).numpy()
    assert got.shape == (2, 24, 40, 16)
    assert not got[..., 12:].any()
    _assert_u8_close(got, ref)


def test_scale2x_batch_fast_matches_non_kernel_path(params_np, fast32, rng):
    yuv = torch.from_numpy(rng.random((1, 14, 10, 3), dtype=np.float32))
    model = SRCNN.from_params(params_from_numpy(params_np))
    cfg = Config(mode="scale", block_size=0)
    ref = pl.scale2x_batch(yuv, model, cfg)
    got = pl.scale2x_batch_fast(yuv, fast32)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    jref = np.asarray(jpl.scale2x_batch(jnp.asarray(yuv.numpy()), params_np,
                                        JConfig(mode="scale", block_size=0)))
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("step", ["u8_fused", "fast"])
def test_banded_equals_unbanded(fast32, rng, step):
    """150 low-res rows in 64-row bands (3 bands, 4-row halo each side)
    against one dispatch: exact."""
    fn = {"u8_fused": pl.scale2x_batch_u8_fused,
          "fast": pl.scale2x_batch_fast}[step]
    yuv = torch.from_numpy(rng.random((1, 150, 12, 3), dtype=np.float32))
    whole = fn(yuv, fast32, band_rows=1152)
    banded = fn(yuv, fast32, band_rows=64)
    assert list(pl._bands(150, 64)) == [(0, 58, 0, 50), (46, 58, 4, 50),
                                        (92, 58, 8, 50)]
    torch.testing.assert_close(banded, whole, rtol=0, atol=0)


@pytest.mark.parametrize("ratio", [1.5, 2.0, 2.41, 4.0])
def test_converter_matches_jax(model_dir, rng, ratio):
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    ref = jpl.Converter.from_config(JConfig(
        mode="scale", scale_ratio=ratio, model_dir=model_dir,
        use_pallas=False)).process_bgr_u8(img)
    conv = pl.Converter.from_config(Config(
        mode="scale", scale_ratio=ratio, model_dir=model_dir), device="cpu")
    assert conv.fast_scale is None   # "auto" on the CPU: non-kernel path
    _assert_u8_close(conv.process_bgr_u8(img), ref)


@pytest.mark.parametrize("ratio", [2.0, 4.0])
def test_converter_kernel_path_matches_jax(model_dir, rng, ratio):
    """use_pallas=True on the CPU: the kernel path with the stack's plain
    version (f32), ending in the u8 tail (_final_fast_u8); the JAX
    package's own bar between its kernel and non-kernel paths."""
    img = rng.integers(0, 256, (26, 22, 3), dtype=np.uint8)
    ref = jpl.Converter.from_config(JConfig(
        mode="scale", scale_ratio=ratio, model_dir=model_dir,
        use_pallas=False)).process_bgr_u8(img)
    conv = pl.Converter.from_config(Config(
        mode="scale", scale_ratio=ratio, model_dir=model_dir, use_pallas=True,
        compute_dtype="float32"), device="cpu")
    assert conv.fast_scale is not None
    _assert_u8_close(conv.process_bgr_u8(img), ref, frac=0.01)


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.41,
                                   2.5, 3.9999, 4.0, 8.0])
def test_scale_plan_parity(ratio):
    assert pl.scale_plan(ratio) == jpl.scale_plan(ratio)


def test_scale_plan_rejects_non_positive():
    for r in (0.0, -1.0):
        with pytest.raises(ValueError):
            pl.scale_plan(r)


def test_cuda_default_raises_without_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = Config(mode="scale", model_dir=model_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.Converter.from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.convert_image(np.zeros((8, 8, 3), np.uint8), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.FastStack.build(params_from_numpy(
            as_numpy(init_params(jax.random.PRNGKey(0), JFLAGSHIP))))


@pytest.mark.parametrize("mode", ["noise", "noise_scale"])
def test_noise_modes_not_ported(params_np, tmp_path, rng, mode):
    """Named for the time when the noise modes were not ported; the name is
    kept so that the test's history stays one record. It checks that they
    are ported now: from_config loads the noise model and converts (the
    comparisons with the JAX package are in tests/test_torch_noise.py)."""
    save_model_json(tmp_path / "noise1_model.json", params_np)
    save_model_json(tmp_path / "scale2.0x_model.json", params_np)
    conv = pl.Converter.from_config(Config(mode=mode, model_dir=str(tmp_path)),
                                    device="cpu")
    assert conv.noise_model is not None
    assert (conv.scale_model is not None) == (mode == "noise_scale")
    img = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    out = conv.process_bgr_u8(img)
    assert out.shape == ((10, 12, 3) if mode == "noise" else (20, 24, 3))


def test_faststack_rejects_non_flagship():
    small = params_from_numpy(as_numpy(init_params(
        jax.random.PRNGKey(1), JModelSpec.from_widths([1, 4, 4, 1]))))
    with pytest.raises(ValueError, match="flagship"):
        pl.FastStack.build(small, True, device="cpu")


def test_convert_image_small_arch_matches_jax(rng):
    """An architecture the kernel does not take runs on the non-kernel
    path even under use_pallas=True, as in the JAX package."""
    small = as_numpy(init_params(jax.random.PRNGKey(12),
                                 JModelSpec.from_widths([1, 4, 4, 1])))
    img = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
    for ratio in (1.5, 2.0):
        ref = jpl.convert_image(img, JConfig(mode="scale", scale_ratio=ratio,
                                             use_pallas=False),
                                scale_params=small)
        got = pl.convert_image(img, Config(mode="scale", scale_ratio=ratio,
                                           use_pallas=True),
                               scale_params=params_from_numpy(small),
                               device="cpu")
        _assert_u8_close(got, ref)


def test_process_alpha_matches_jax(model_dir, rng):
    alpha = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    for ratio in (2.0, 2.41):
        ref = jpl.Converter.from_config(JConfig(
            mode="scale", scale_ratio=ratio, model_dir=model_dir,
            use_pallas=False)).process_alpha(alpha)
        got = pl.Converter.from_config(Config(
            mode="scale", scale_ratio=ratio, model_dir=model_dir),
            device="cpu").process_alpha(alpha)
        _assert_u8_close(got, ref)


def test_scale2x_batch_u8_s2d_matches_jax(params_np, fast32, rng):
    """The pixel-major u8 polyphase step against the JAX function, both
    through the plain stack on the CPU, at the u8 bar; its host interleave
    (d2s_host) equals the port's own raster step bit for bit."""
    yuv = rng.random((2, 24, 40, 3), dtype=np.float32)
    jfast = jpl.FastStack.build(params_np, True, tile=(8, 16),
                                dtype=jnp.float32, interpret=True)
    ref = np.asarray(jpl.scale2x_batch_u8_s2d(jnp.asarray(yuv), jfast))
    got = pl.scale2x_batch_u8_s2d(torch.from_numpy(yuv), fast32).numpy()
    assert got.shape == (2, 24, 40, 12)
    _assert_u8_close(got, ref)
    raster = pl._to_bgr_u8(pl.scale2x_batch_fast(torch.from_numpy(yuv),
                                                 fast32)).numpy()
    np.testing.assert_array_equal(d2s_host(got), raster)


@pytest.mark.parametrize("shape", [(40, 40), (21, 45)])
def test_convert_y_bf16_matches_jax(params_np, rng, shape):
    """The non-kernel path with compute_dtype="bfloat16" against the JAX
    _convert_y in bf16 on the same plane: >= 50 dB (peak 1), the bf16 bar.
    Both round activations to bf16 at each layer; the sums differ in order."""
    plane = rng.random(shape, dtype=np.float32)
    ref = np.asarray(jpl._convert_y(
        jnp.asarray(plane), params_np,
        JConfig(mode="scale", compute_dtype="bfloat16", block_size=0)))
    model = SRCNN.from_params(params_from_numpy(params_np))
    got = pl._convert_y(torch.from_numpy(plane)[None], model,
                        Config(mode="scale", compute_dtype="bfloat16"))
    assert got.dtype == torch.float32 and got.shape == (1, *shape)
    assert psnr(got[0].numpy(), ref, peak=1.0) >= 50
    f32 = pl._convert_y(torch.from_numpy(plane)[None], model,
                        Config(mode="scale", compute_dtype="float32"))
    assert not torch.equal(got, f32)   # the bf16 branch was taken


@pytest.fixture
def mesh_log(caplog):
    """caplog on the port's logger, which does not propagate to the root."""
    logger = logging.getLogger("waifu2x_torch.pipeline")
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def _mesh_records(caplog):
    return [r for r in caplog.records if "mesh" in r.getMessage()]


def test_converter_mesh_needs_more_devices_warns_once(model_dir, rng,
                                                      mesh_log):
    conv = pl.Converter.from_config(Config(
        mode="scale", model_dir=model_dir, mesh="2x1", use_pallas=True,
        compute_dtype="float32"), device="cpu")
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    for _ in range(2):
        assert conv.process_bgr_u8(img).shape == (24, 20, 3)
    recs = _mesh_records(mesh_log)
    assert [r.getMessage() for r in recs] == [
        "mesh (2, 1, 1) needs 2 devices, have 1; running single-device"]
    assert recs[0].levelno == logging.WARNING


@pytest.mark.parametrize("mesh", ["auto", "off", "1x1"])
def test_converter_single_device_mesh_is_silent(model_dir, rng, mesh_log,
                                                mesh):
    conv = pl.Converter.from_config(Config(
        mode="scale", model_dir=model_dir, mesh=mesh, use_pallas=True,
        compute_dtype="float32"), device="cpu")
    conv.process_bgr_u8(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8))
    assert not _mesh_records(mesh_log)


def test_converter_mesh_without_kernel_stacks_warns_once(model_dir, rng,
                                                         mesh_log):
    """The non-kernel path cannot shard: one warning, as in the JAX
    package, then a single-device conversion."""
    conv = pl.Converter.from_config(Config(
        mode="scale", model_dir=model_dir, mesh="2x1"), device="cpu")
    assert conv.fast_scale is None
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    for _ in range(2):
        conv.process_bgr_u8(img)
    recs = _mesh_records(mesh_log)
    assert len(recs) == 1 and "kernel stacks" in recs[0].getMessage()


def test_converter_mesh_the_devices_hold_shards(model_dir, rng,
                                               monkeypatch):
    """A mesh that fits the host's devices (here 8 CPU positions) shards the
    conversion, as in the JAX package: process_bgr_u8 runs MeshPipeline,
    and the output equals the one-device conversion."""
    from waifu2x_torch.parallel import mesh as tmesh
    from waifu2x_torch.parallel import mesh_pipeline

    monkeypatch.setattr(tmesh, "CPU_DEVICES", 8)
    calls = []
    orig = mesh_pipeline.MeshPipeline.convert_bgr_u8

    def spy(self, bgr_u8):
        calls.append(self.mesh.shape)
        return orig(self, bgr_u8)

    monkeypatch.setattr(mesh_pipeline.MeshPipeline, "convert_bgr_u8", spy)
    kw = dict(mode="scale", model_dir=model_dir, use_pallas=True,
              compute_dtype="float32")
    conv = pl.Converter.from_config(Config(mesh="2x4", **kw), device="cpu")
    img = rng.integers(0, 256, (24, 40, 3), np.uint8)
    got = conv.process_bgr_u8(img)
    assert calls == [(2, 1, 4)]
    ref = pl.Converter.from_config(Config(mesh="off", **kw),
                                   device="cpu").process_bgr_u8(img)
    np.testing.assert_array_equal(got, ref)
