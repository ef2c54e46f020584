"""The port's noise slice on the CPU against the JAX package: the noise
stack wrappers (waifu2x_torch.ops.stack, which take their plain PyTorch
versions on CPU tensors), the noise steps of waifu2x_torch.pipeline, the
noise_scale chain and the Converter / convert_image noise modes.

Bars: f32 stacks within 3e-5, the JAX kernel suite's own
(tests/test_pallas_stack.py); f32 YUV steps within 1e-4
(tests/test_fastpath.py); u8 outputs equal except |diff| <= 1 on < 0.2% of
pixels where the two sides round the final u8 from f32 sums taken in
another order; banding exact; bf16 storage >= 50 dB PSNR (peak 1) against
f32. The Pallas interpreter runs only at the JAX suite's own small sizes.
The CUDA kernel itself is held against the plain versions on the card by
chip_smoke.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.config import Config as JConfig
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.models.weights import save_model_json
from waifu2x_tpu.ops.convstack import convert_plane as jconvert_plane
from waifu2x_tpu.ops.pallas_stack import prep_params as jprep_params
from waifu2x_tpu.ops.pallas_stack import stack_noise as jstack_noise
from waifu2x_tpu.ops.pallas_stack import stack_noise_s2d as jstack_noise_s2d
from waifu2x_torch import pipeline as pl
from waifu2x_torch.config import Config
from waifu2x_torch.models.srcnn import SRCNN
from waifu2x_torch.models.weights import load_model_json, params_from_numpy
from waifu2x_torch.ops import stack

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def fast_n(params_np):
    return pl.FastStack.build(params_from_numpy(params_np), False,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def fast_s(params_np):
    return pl.FastStack.build(params_from_numpy(params_np), True,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jfast_n(params_np):
    return jpl.FastStack.build(params_np, False, tile=(16, 16),
                               interpret=True, dtype=jnp.float32)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """noise1 / noise2 / scale2.0x models with distinct seeded weights."""
    d = tmp_path_factory.mktemp("models")
    for name, seed in (("noise1", 21), ("noise2", 22), ("scale2.0x", 23)):
        save_model_json(d / f"{name}_model.json",
                        as_numpy(init_params(jax.random.PRNGKey(seed),
                                             JFLAGSHIP)))
    return str(d)


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


# --- the noise stack (ops/stack.py) -----------------------------------------

@pytest.mark.parametrize("h,w,tile", [(32, 32, (8, 16)), (27, 38, (8, 16))])
def test_stack_noise_matches_pallas_interpret(params_np, sp32, rng, h, w,
                                              tile):
    y = rng.random((1, h, w), dtype=np.float32)
    kp, spec = jprep_params(params_np, scale_input=False, dtype=jnp.float32)
    ref = np.asarray(jstack_noise(jnp.asarray(y), kp, spec, tile=tile,
                                  interpret=True))
    got = stack.stack_noise(torch.from_numpy(y), sp32)
    assert got.shape == (1, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("n,h,w", [(2, 27, 38), (1, 5, 31), (1, 9, 9),
                                   (2, 16, 13), (1, 1, 6)])
def test_stack_noise_matches_convert_plane(params_np, sp32, rng, n, h, w):
    """Odd sizes run on the plane edge-padded to even and are cropped:
    the same-size replicate-pad conversion of the reference."""
    y = rng.random((n, h, w), dtype=np.float32)
    ref = np.asarray(jconvert_plane(jnp.asarray(y), params_np,
                                    precision="highest"))
    got = stack.stack_noise(torch.from_numpy(y), sp32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


def test_stack_noise_s2d_matches_pallas_interpret(params_np, sp32, rng):
    y = rng.random((2, 16, 24), dtype=np.float32)
    kp, spec = jprep_params(params_np, scale_input=False, dtype=jnp.float32)
    ref = np.asarray(jstack_noise_s2d(jnp.asarray(y), kp, spec,
                                      tile=(8, 16), interpret=True))
    got = stack.stack_noise_s2d(torch.from_numpy(y), sp32)
    assert got.shape == (2, 8, 12, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("fn", [stack.stack_noise_s2d,
                                stack.stack_noise_s2d_plain])
def test_stack_noise_s2d_rejects_odd_dims(sp32, fn):
    for shape in ((1, 7, 8), (1, 8, 7)):
        with pytest.raises(ValueError, match="even"):
            fn(torch.rand(shape), sp32)


@pytest.mark.parametrize("fn", [stack.stack_noise, stack.stack_noise_s2d])
def test_noise_wrappers_reject_bad_input(sp32, fn):
    sp16 = tuple((w.to(torch.bfloat16), b) for w, b in sp32)
    with pytest.raises(TypeError):
        fn(torch.rand(1, 8, 8).double(), sp32)
    with pytest.raises(TypeError):
        fn(torch.rand(1, 8, 8), sp16)
    with pytest.raises(ValueError):
        fn(torch.rand(8, 8), sp32)


def test_noise_stack_plain_bf16_fidelity(rng):
    """bf16 storage of the shipped noise weights on an image-like plane:
    >= 50 dB against f32, and equal to the bf16 plain version."""
    params = load_model_json(ROOT / "models" / "noise1_demo.json")
    yy, xx = np.mgrid[0:48, 0:66].astype(np.float32)
    y = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
         + 0.02 * rng.standard_normal((48, 66))).astype(np.float32)[None]
    sp32 = stack.prep_params(params, torch.float32, "cpu")
    y32 = stack.stack_noise_s2d(torch.from_numpy(y), sp32)
    sp16 = stack.prep_params(params, torch.bfloat16, "cpu")
    y16 = stack.stack_noise_s2d(torch.from_numpy(y).to(torch.bfloat16), sp16)
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(
        y16, stack.stack_noise_s2d_plain(torch.from_numpy(y)
                                         .to(torch.bfloat16), sp16),
        rtol=0, atol=0)
    mse = torch.mean((y16.double() - y32.double()) ** 2).item()
    assert 10 * np.log10(1.0 / mse) >= 50.0


def test_noise_no_launches_on_cpu(sp32, rng):
    before = stack.LAUNCHES
    y = torch.from_numpy(rng.random((1, 6, 8), dtype=np.float32))
    stack.stack_noise(y, sp32)
    stack.stack_noise_s2d(y, sp32)
    stack.stack_noise_plain(y, sp32)
    assert stack.LAUNCHES == before == 0


# --- the noise steps (pipeline.py) ------------------------------------------

def test_noise_batch_matches_jax(params_np, rng):
    yuv = rng.random((2, 20, 26, 3), dtype=np.float32)
    ref = np.asarray(jpl.noise_batch(jnp.asarray(yuv), params_np,
                                     JConfig(mode="noise", block_size=0)))
    model = SRCNN.from_params(params_from_numpy(params_np))
    got = pl.noise_batch(torch.from_numpy(yuv), model,
                         Config(mode="noise", block_size=0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.numpy()[..., 1:], yuv[..., 1:])


def test_noise_batch_fast_matches_jax(fast_n, jfast_n, rng):
    yuv = rng.random((2, 20, 26, 3), dtype=np.float32)
    ref = np.asarray(jpl.noise_batch_fast(jnp.asarray(yuv), jfast_n))
    got = pl.noise_batch_fast(torch.from_numpy(yuv), fast_n)
    assert got.shape == yuv.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_noise_batch_fast_odd_dims_match_non_kernel_path(params_np, fast_n,
                                                         rng):
    yuv = torch.from_numpy(rng.random((1, 21, 17, 3), dtype=np.float32))
    model = SRCNN.from_params(params_from_numpy(params_np))
    ref = pl.noise_batch(yuv, model, Config(mode="noise", block_size=0))
    torch.testing.assert_close(pl.noise_batch_fast(yuv, fast_n), ref,
                               rtol=0, atol=1e-4)


def test_noise_batch_u8_fused_matches_jax(fast_n, jfast_n, rng):
    yuv = rng.random((2, 24, 32, 3), dtype=np.float32)
    ref = np.asarray(jpl.noise_batch_u8_fused(jnp.asarray(yuv), jfast_n))
    got = pl.noise_batch_u8_fused(torch.from_numpy(yuv), fast_n).numpy()
    assert got.shape == (2, 12, 16, 16)
    assert not got[..., 12:].any()
    _assert_u8_close(got, ref)


def test_noise_batch_u8_fused_rejects_odd_dims(fast_n):
    for shape in ((1, 21, 32, 3), (1, 20, 31, 3)):
        with pytest.raises(ValueError, match="even"):
            pl.noise_batch_u8_fused(torch.zeros(shape), fast_n)


def test_noise_y_out_dtype_passthrough(params_np, rng):
    """out_dtype=None hands the kernel's storage dtype through; the
    default is f32 and equals the cast of the passthrough result."""
    fast16 = pl.FastStack.build(params_from_numpy(params_np), False,
                                dtype=torch.bfloat16, device="cpu")
    y = torch.from_numpy(rng.random((1, 20, 24), dtype=np.float32))
    a = pl.noise_y_batch_fast(y, fast16)
    b = pl.noise_y_batch_fast(y, fast16, out_dtype=None)
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    torch.testing.assert_close(a, b.float(), rtol=0, atol=0)


def _n_noise_bands(h, band_rows, n, w):
    return len(list(pl._bands(h, pl._noise_band_rows(band_rows, n, w),
                              pl._NOISE_HALO, 2)))


@pytest.mark.parametrize("h", [300, 301])
def test_noise_batch_fast_banded_equals_unbanded(fast_n, rng, h):
    """Frames taller than the 128-row band floor, in 3 bands (an odd
    height is edge-padded to even inside the bander): exact."""
    yuv = torch.from_numpy(rng.random((1, h, 12, 3), dtype=np.float32))
    assert _n_noise_bands(h + h % 2, 128, 1, 12) == 3
    whole = pl.noise_batch_fast(yuv, fast_n, band_rows=2304)
    banded = pl.noise_batch_fast(yuv, fast_n, band_rows=128)
    torch.testing.assert_close(banded, whole, rtol=0, atol=0)


def test_noise_batch_u8_fused_banded_equals_unbanded(fast_n, rng):
    """320 rows in 160-row bands (8-row halo, u8 rows sliced at
    (b0 - s) // 2): exact."""
    yuv = torch.from_numpy(rng.random((1, 320, 16, 3), dtype=np.float32))
    assert _n_noise_bands(320, 160, 1, 16) == 2
    whole = pl.noise_batch_u8_fused(yuv, fast_n, band_rows=320)
    banded = pl.noise_batch_u8_fused(yuv, fast_n, band_rows=160)
    torch.testing.assert_close(banded, whole, rtol=0, atol=0)


def test_chain_y_override_banded_exact(fast_n, fast_s, rng):
    """noise_y_batch_fast -> scale2x_batch_u8_fused(y=...): every mix of
    noise and scale band sizes gives the same output. 160 rows exceed
    both band floors (noise 128, scale 64)."""
    yuv = torch.from_numpy(rng.random((1, 160, 16, 3), dtype=np.float32))

    def chain(nb, sb):
        y = pl.noise_y_batch_fast(yuv[..., 0], fast_n, band_rows=nb,
                                  out_dtype=None)
        return pl.scale2x_batch_u8_fused(yuv, fast_s, band_rows=sb, y=y)

    ref = chain(256, 256)
    for nb, sb in ((256, 64), (256, 96), (128, 256), (128, 64)):
        torch.testing.assert_close(chain(nb, sb), ref, rtol=0, atol=0)


def test_chain_matches_jax(params_np, fast_n, fast_s, jfast_n, rng):
    """The ns1080-style chain at a small size against the JAX package's
    (interpret mode, f32)."""
    yuv = rng.random((1, 16, 20, 3), dtype=np.float32)
    jfast_s = jpl.FastStack.build(params_np, True, tile=(16, 16),
                                  interpret=True, dtype=jnp.float32)
    jy = jpl.noise_y_batch_fast(jnp.asarray(yuv[..., 0]), jfast_n,
                                out_dtype=None)
    ref = np.asarray(jpl.scale2x_batch_u8_fused(jnp.asarray(yuv), jfast_s,
                                                y=jy))
    t = torch.from_numpy(yuv)
    got = pl.scale2x_batch_u8_fused(
        t, fast_s, y=pl.noise_y_batch_fast(t[..., 0], fast_n,
                                           out_dtype=None)).numpy()
    _assert_u8_close(got, ref, frac=0.01)


@pytest.mark.parametrize("mode,dtype", [
    ("noise_scale", "auto"), ("noise_scale", "float32"),
    ("noise_scale", "bfloat16"), ("noise", "auto"), ("scale", "auto")])
def test_noise_dtype_for_matches_jax(mode, dtype):
    want = jpl._noise_dtype_for(JConfig(mode=mode, compute_dtype=dtype))
    got = pl._noise_dtype_for(Config(mode=mode, compute_dtype=dtype))
    assert (got is None) == (want is None)
    if want is not None:
        assert want == jnp.float32 and got == torch.float32


# --- Converter and convert_image --------------------------------------------

@pytest.mark.parametrize("mode,level", [("noise", 1), ("noise", 2),
                                        ("noise_scale", 1),
                                        ("noise_scale", 2)])
def test_converter_noise_modes_match_jax(model_dir, rng, mode, level):
    img = rng.integers(0, 256, (27, 34, 3), dtype=np.uint8)
    ref = jpl.Converter.from_config(JConfig(
        mode=mode, noise_level=level, model_dir=model_dir,
        use_pallas=False)).process_bgr_u8(img)
    conv = pl.Converter.from_config(Config(
        mode=mode, noise_level=level, model_dir=model_dir), device="cpu")
    assert conv.fast_noise is None   # "auto" on the CPU: non-kernel path
    got = conv.process_bgr_u8(img)
    assert got.shape == ((27, 34, 3) if mode == "noise" else (54, 68, 3))
    _assert_u8_close(got, ref)


@pytest.mark.parametrize("mode,shape", [("noise", (26, 22, 3)),
                                        ("noise", (25, 21, 3)),
                                        ("noise_scale", (26, 22, 3)),
                                        ("noise_scale", (25, 21, 3))])
def test_converter_noise_kernel_path_matches_jax(model_dir, rng, mode,
                                                 shape):
    """use_pallas=True on the CPU: the noise stack's plain version (f32),
    odd images through noise_batch_fast; against the JAX package's
    non-kernel path at its own kernel-vs-non-kernel bar."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = jpl.Converter.from_config(JConfig(
        mode=mode, model_dir=model_dir, use_pallas=False)).process_bgr_u8(img)
    conv = pl.Converter.from_config(Config(
        mode=mode, model_dir=model_dir, use_pallas=True,
        compute_dtype="float32"), device="cpu")
    assert conv.fast_noise is not None
    _assert_u8_close(conv.process_bgr_u8(img), ref, frac=0.01)


def test_converter_auto_policy_f32_noise_stack(model_dir):
    """noise_scale under compute_dtype="auto": f32 noise stack, bf16 scale
    stack; an explicit choice wins."""
    conv = pl.Converter.from_config(Config(
        mode="noise_scale", model_dir=model_dir, use_pallas=True),
        device="cpu")
    assert conv.fast_noise.dtype == torch.float32
    assert conv.fast_scale.dtype == torch.bfloat16
    conv = pl.Converter.from_config(Config(
        mode="noise_scale", model_dir=model_dir, use_pallas=True,
        compute_dtype="bfloat16"), device="cpu")
    assert conv.fast_noise.dtype == conv.fast_scale.dtype == torch.bfloat16


def test_from_config_default_mode(model_dir, rng):
    """The default Config (mode="noise_scale", noise level 1) converts."""
    conv = pl.Converter.from_config(Config(model_dir=model_dir),
                                    device="cpu")
    assert conv.noise_model is not None and conv.scale_model is not None
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    assert conv.process_bgr_u8(img).shape == (24, 20, 3)


@pytest.mark.parametrize("mode", ["noise", "noise_scale"])
def test_convert_image_noise_modes_match_jax(rng, mode):
    noise = as_numpy(init_params(jax.random.PRNGKey(31), JFLAGSHIP))
    scale = as_numpy(init_params(jax.random.PRNGKey(32), JFLAGSHIP))
    img = rng.integers(0, 256, (23, 30, 3), dtype=np.uint8)
    ref = jpl.convert_image(img, JConfig(mode=mode, use_pallas=False),
                            noise_params=noise, scale_params=scale)
    got = pl.convert_image(img, Config(mode=mode),
                           noise_params=params_from_numpy(noise),
                           scale_params=params_from_numpy(scale),
                           device="cpu")
    _assert_u8_close(got, ref)
