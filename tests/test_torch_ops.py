"""The port's plain ops (colour maps, resizes, conv stack, s2d layouts)
against the JAX package's on seeded numpy inputs.

Tolerances: colour maps and layouts are exact (same f32 operations in the
same order); resizes 1e-6 (the tap sums may associate differently);
the f32 conv stack 1e-5 (summation order of F.conv2d vs XLA's HIGHEST
precision convolution)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER, as_numpy, init_params
import waifu2x_tpu.ops.color as jcolor
import waifu2x_tpu.ops.convstack as jconv
import waifu2x_tpu.ops.s2d as js2d
import waifu2x_tpu.utils.metrics as jmetrics
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import color, convstack, resize, s2d
from waifu2x_torch.utils import metrics

# the JAX package's ops/__init__ re-exports the `resize` function under the
# submodule's name, so take the module from sys.modules
jresize = importlib.import_module("waifu2x_tpu.ops.resize")

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def params_np():
    import jax
    return as_numpy(init_params(jax.random.PRNGKey(3), WAIFU2X_7LAYER))


@pytest.mark.parametrize("fn", ["bgr_to_yuv", "yuv_to_bgr"])
def test_color_maps_bit_equal(rng, fn):
    img = rng.random((2, 17, 23, 3), dtype=np.float32)
    got = getattr(color, fn)(_t(img)).numpy()
    ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(img)))
    np.testing.assert_array_equal(got, ref)


def test_saturate_cast_u8_ties_and_clamp(rng):
    # values whose f32 product with 255 lands exactly on k + 0.5: rounding
    # must go half-to-even in both packages
    k = np.arange(-3, 260, dtype=np.float32)
    cand = ((k + np.float32(0.5)) / np.float32(255)).astype(np.float32)
    ties = cand[cand * np.float32(255) == k + np.float32(0.5)]
    assert ties.size > 50
    vals = np.concatenate([ties, rng.random(500, dtype=np.float32) * 1.4 - 0.2,
                           np.array([-1e9, 1e9, 0, 1], np.float32)])
    got = color.saturate_cast_u8(_t(vals)).numpy()
    ref = np.asarray(jcolor.saturate_cast_u8(jnp.asarray(vals)))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8


def test_u8_to_unit_f32_bit_equal():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        color.u8_to_unit_f32(_t(u8)).numpy(),
        np.asarray(jcolor.u8_to_unit_f32(jnp.asarray(u8))))


@pytest.mark.parametrize("interp", [resize.NEAREST, resize.LINEAR,
                                    resize.CUBIC])
@pytest.mark.parametrize("dsize", [(22, 30), (33, 19), (7, 46)],
                         ids=["x2", "non_integer", "mixed"])
def test_resize_matches_jax(rng, interp, dsize):
    img = rng.random((11, 15, 3), dtype=np.float32)
    got = resize.resize(_t(img), dsize, interp).numpy()
    ref = np.asarray(jresize.resize(jnp.asarray(img), dsize, interp))
    assert got.shape == ref.shape == dsize + (3,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_resize_batched_h_axis(rng):
    img = rng.random((2, 9, 14, 3), dtype=np.float32)
    got = resize.resize(_t(img), (18, 28), resize.CUBIC, h_axis=1).numpy()
    ref = np.asarray(jresize.resize(jnp.asarray(img), (18, 28), resize.CUBIC,
                                    h_axis=1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("interp", [resize.CUBIC, resize.LINEAR])
def test_resize2x_phases_matches_jax(rng, interp):
    img = rng.random((2, 9, 14, 2), dtype=np.float32)
    got = resize.resize2x_phases(_t(img), interp, h_axis=1).numpy()
    ref = np.asarray(jresize.resize2x_phases(jnp.asarray(img), interp,
                                             h_axis=1))
    assert got.shape == (2, 9, 14, 2, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # and the phases interleave to the port's own full resize
    full = resize.resize(_t(img), (18, 28), interp, h_axis=1).numpy()
    for a in (0, 1):
        for b in (0, 1):
            np.testing.assert_allclose(got[..., a * 2 + b],
                                       full[:, a::2, b::2], rtol=0, atol=1e-6)


def test_phase_taps_equal():
    for interp in (resize.CUBIC, resize.LINEAR):
        offs, w = resize._phase_taps(interp)
        joffs, jw = jresize._phase_taps(interp)
        np.testing.assert_array_equal(offs, joffs)
        np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("shape", [(20, 24), (2, 13, 9)])
def test_convert_plane_matches_jax(rng, params_np, shape):
    y = rng.random(shape, dtype=np.float32)
    got = convstack.convert_plane(_t(y), params_from_numpy(params_np)).numpy()
    ref = np.asarray(jconv.convert_plane(jnp.asarray(y), params_np,
                                         precision="highest"))
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_conv_stack_valid_matches_jax(rng, params_np):
    x = rng.random((1, 20, 18, 1), dtype=np.float32)
    got = convstack.conv_stack_valid(_t(x), params_from_numpy(params_np))
    ref = np.asarray(jconv.conv_stack_valid(jnp.asarray(x), params_np,
                                            precision="highest"))
    assert got.shape == (1, 6, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_leaky_relu_matches_jax(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(
        convstack.leaky_relu(_t(x)).numpy(),
        np.asarray(jconv.leaky_relu(jnp.asarray(x))))


def test_s2d_layouts_equal(rng):
    x = rng.random((2, 6, 10, 3), dtype=np.float32)
    got = s2d.s2d(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js2d.s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(s2d.d2s(_t(got)).numpy(), x)
    np.testing.assert_array_equal(s2d.d2s_host(got), js2d.d2s_host(got))
    u8 = rng.integers(0, 256, (2, 5, 7, 16), dtype=np.uint8)
    np.testing.assert_array_equal(s2d.d2s_host_cmajor(u8),
                                  js2d.d2s_host_cmajor(u8))
    assert s2d.d2s_host_cmajor(u8).shape == (2, 10, 14, 3)


def test_metrics_match_jax(rng):
    a = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-2, 3, a.shape), 0, 255)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    assert metrics.megapixels((1080, 1920, 3)) == jmetrics.megapixels(
        (1080, 1920, 3))
    got, ref = metrics.Throughput(), jmetrics.Throughput()
    assert got.mp_per_s == ref.mp_per_s == 0.0
    for t in (got, ref):
        t.add(4_000_000, 0.5)
        t.add(2_000_000, 0.25)
    assert got.mp_per_s == ref.mp_per_s == 8.0
