"""The port's one-step kernel path on a ("dp", "sp") mesh
(waifu2x_torch/parallel/fast_sharded.py) on 8 positions of the CPU device,
against the JAX package's parallel/fast_sharded.py on its 8 virtual CPU
devices with an interpret-mode f32 FastStack (as tests/test_fast_sharded.py
builds it), on seeded numpy inputs.

Bars: against the port's own single-device step, bit for bit (each shard
runs the same plain stack per pixel); against JAX, the u8 outputs at the
tie bar of tests/test_torch_pipeline.py (|diff| <= 1 at < 0.2% of bytes)
and the f32 noise planes within 3e-5 (tests/test_torch_noise.py's bar for
the stack against the interpret-mode kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.parallel import fast_sharded as jfs
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.parallel import fast_sharded as fs
from waifu2x_torch.parallel import mesh as m

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(m, "CPU_DEVICES", 8)


@pytest.fixture(scope="module")
def params_s():
    return as_numpy(init_params(jax.random.PRNGKey(5), JFLAGSHIP))


@pytest.fixture(scope="module")
def params_n():
    return as_numpy(init_params(jax.random.PRNGKey(6), JFLAGSHIP))


@pytest.fixture(scope="module")
def fast(params_s):
    return pl.FastStack.build(params_from_numpy(params_s), True,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def fast_noise(params_n):
    return pl.FastStack.build(params_from_numpy(params_n), False,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jfast(params_s):
    return jpl.FastStack.build(params_s, scale_input=True, tile=(16, 16),
                               interpret=True, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jfast_noise(params_n):
    return jpl.FastStack.build(params_n, scale_input=False, tile=(16, 16),
                               interpret=True, dtype=jnp.float32)


def _meshes(shape):
    n = shape[0] * shape[1]
    return (fs.make_mesh(shape, m.local_devices("cpu")[:n]),
            jfs.make_mesh(shape, jax.devices()[:n]))


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)])
def test_scale_sharded_matches_single_device(fast, rng, shape):
    mesh, _ = _meshes(shape)
    yuv = torch.from_numpy(rng.random((4, 24, 40, 3), dtype=np.float32))
    got = m.gather(fs.scale2x_u8_s2d_sharded(yuv, fast, mesh))
    torch.testing.assert_close(got, pl.scale2x_batch_u8_s2d(yuv, fast),
                               rtol=0, atol=0)


def test_scale_sharded_pad_and_crop_matches_jax(fast, jfast, rng):
    """Width 37 does not divide sp = 4: convert_batch_on_mesh pads, runs
    scale2x_u8_s2d_sharded and crops, in both packages."""
    mesh, jmesh = _meshes((2, 4))
    yuv = rng.random((2, 16, 37, 3), dtype=np.float32)
    got = fs.convert_batch_on_mesh(torch.from_numpy(yuv), fast, mesh)
    torch.testing.assert_close(
        got, pl.scale2x_batch_u8_s2d(torch.from_numpy(yuv), fast),
        rtol=0, atol=0)
    ref = np.asarray(jfs.convert_batch_on_mesh(jnp.asarray(yuv), jfast,
                                               jmesh))
    _assert_u8_close(got.numpy(), ref)
    padded, w = fs.pad_width_to_mesh(torch.from_numpy(yuv), mesh)
    jpadded, jw = jfs.pad_width_to_mesh(jnp.asarray(yuv), jmesh)
    assert w == jw == 37
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_noise_sharded_matches_single_device(fast_noise, rng, shape):
    mesh, _ = _meshes(shape)
    y = torch.from_numpy(rng.random((2, 20, 80), dtype=np.float32))
    got = m.gather(fs.noise_plane_sharded(y, fast_noise, mesh))
    torch.testing.assert_close(got, fast_noise.noise(y), rtol=0, atol=0)


def test_noise_sharded_odd_width_matches_jax(fast_noise, jfast_noise, rng):
    """noise_batch_on_mesh pads the width to even shards, runs
    noise_plane_sharded and crops, in both packages."""
    mesh, jmesh = _meshes((2, 4))
    y = rng.random((2, 18, 69), dtype=np.float32)
    got = fs.noise_batch_on_mesh(torch.from_numpy(y), fast_noise, mesh)
    assert got.shape == (2, 18, 69)
    torch.testing.assert_close(got, fast_noise.noise(torch.from_numpy(y)),
                               rtol=0, atol=0)
    ref = np.asarray(jfs.noise_batch_on_mesh(jnp.asarray(y), jfast_noise,
                                             jmesh))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


def test_narrow_shard_raises(fast, jfast, rng):
    """A width shard narrower than the halo: the same ValueError in both
    packages (3 columns on sp = 8 against the 4-column halo)."""
    mesh, jmesh = _meshes((1, 8))
    yuv = rng.random((1, 8, 24, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="narrower than the 4-col halo"):
        fs.scale2x_u8_s2d_sharded(torch.from_numpy(yuv), fast, mesh)
    with pytest.raises(ValueError, match="narrower than the 4-col halo"):
        jfs.scale2x_u8_s2d_sharded(jnp.asarray(yuv), jfast, jmesh)


def test_make_mesh_axes():
    mesh = fs.make_mesh((2, 4), m.local_devices("cpu"))
    assert mesh.axis_names == ("dp", "sp") and mesh.shape == (2, 4)
    assert fs.make_mesh(devices=m.local_devices("cpu")).shape == (1, 8)
    with pytest.raises(ValueError, match="devices"):
        fs.make_mesh((3, 3), m.local_devices("cpu"))
