"""Layer 6's two switches on the port's product paths, on the CPU against
the JAX package under the same switch: the scale step in both tails, the
noise step and the stream runtime (stack.L6_I8 / stack.L6_WINO, the JAX
package's W2X_L6_I8 / W2X_L6_WINO), and the forward half of train/qat.py.
The port's FastStacks take the plain PyTorch versions on the CPU (f32); the
JAX side runs its Pallas kernel in interpret mode, f32, tile (16, 16).

Bars: u8 outputs equal except |diff| <= 1 on < 0.5% of bytes, the bar of
the port's other step tests, at one tile geometry on both sides; streams
equal to the batch step bit for bit; the fake-quantised stack within 1e-5
and its gap within 0.01 dB of the JAX functions at precision="highest".
The wrappers themselves are held in tests/test_torch_l6.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
import waifu2x_tpu.stream as jstream
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_tpu.ops.convstack import conv_stack_valid as jconv_stack_valid
from waifu2x_tpu.train import qat as jqat
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import d2s_host_cmajor
from waifu2x_torch.stream import StreamConverter, _to_yuv_batch
from waifu2x_torch.train import qat

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


def _switch(monkeypatch, form):
    """Set layer 6's form on both sides. The JAX kernel resolves its
    switch when it is traced, so its cache is dropped around the flip."""
    for mod in (stack, jps):
        monkeypatch.setattr(mod, "L6_I8", form == "i8")
        monkeypatch.setattr(mod, "L6_WINO", form == "wino")
    jps._run_stack.clear_cache()


@pytest.fixture
def fast_pair(params_np):
    """Both packages' FastStacks, f32. The 16 x 16 frames below are one
    (16, 16) tile on the JAX side and one default tile on the port's, so
    the int8 geometry is the same on both."""
    fast = pl.FastStack.build(params_from_numpy(params_np), True,
                              dtype=torch.float32, device="cpu")
    jfast = jpl.FastStack.build(params_np, scale_input=True, tile=(16, 16),
                                interpret=True, dtype=jnp.float32)
    yield fast, jfast
    jps._run_stack.clear_cache()


def _assert_u8_close(got, ref, frac=0.005):
    """The u8 bar of the port's other step tests: |diff| <= 1 level at
    under 0.5% of bytes."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


@pytest.mark.parametrize("tail", ["xla", "kernel"])
@pytest.mark.parametrize("form", ["i8", "wino"])
def test_step_follows_the_l6_switches(fast_pair, rng, monkeypatch, form,
                                      tail):
    """scale2x_batch_u8_fused under each switch against the JAX step under
    the same switch, at the same tile geometry: the u8 bar. It differs
    from the step with the switch off, and FastStack.scale is the wrapper
    under the switch."""
    fast, jfast = fast_pair
    yuv = rng.random((2, 16, 16, 3), dtype=np.float32)
    t = torch.from_numpy(yuv)
    for mod in (pl, jpl):
        monkeypatch.setattr(mod, "FUSED_TAIL", tail)
    monkeypatch.setattr(jps, "UVP_MODE", "f32")
    default = pl.scale2x_batch_u8_fused(t, fast).numpy()
    y_default = fast.scale(t[..., 0])
    _switch(monkeypatch, form)
    ref = np.asarray(jpl.scale2x_batch_u8_fused(jnp.asarray(yuv), jfast))
    got = pl.scale2x_batch_u8_fused(t, fast).numpy()
    _assert_u8_close(got, ref)
    y = fast.scale(t[..., 0])
    assert torch.equal(y, stack.stack_scale(
        t[..., 0].contiguous(), fast.sp, **{"l6_" + form: True}))
    assert not torch.equal(y, y_default)
    if form == "i8":
        assert not np.array_equal(got, default)


@pytest.mark.parametrize("form", ["i8", "wino"])
def test_noise_step_follows_the_l6_switches(params_np, rng, monkeypatch,
                                            form):
    """The switches act on the noise stack too: noise_batch_u8_fused
    against the JAX step (32 x 32 frames: one tile of 16 x 16 cells)."""
    fast = pl.FastStack.build(params_from_numpy(params_np), False,
                              dtype=torch.float32, device="cpu")
    jfast = jpl.FastStack.build(params_np, scale_input=False, tile=(16, 16),
                                interpret=True, dtype=jnp.float32)
    yuv = rng.random((2, 32, 32, 3), dtype=np.float32)
    t = torch.from_numpy(yuv)
    default = fast.noise_s2d(t[..., 0])
    _switch(monkeypatch, form)
    try:
        ref = np.asarray(jpl.noise_batch_u8_fused(jnp.asarray(yuv), jfast))
    finally:
        jps._run_stack.clear_cache()
    _assert_u8_close(pl.noise_batch_u8_fused(t, fast).numpy(), ref)
    assert not torch.equal(fast.noise_s2d(t[..., 0]), default)


@pytest.mark.parametrize("form", ["i8", "wino"])
def test_stream_follows_the_l6_switches(fast_pair, rng, monkeypatch, form):
    """StreamConverter.process_frames under each switch: equal to the batch
    step on the same batches bit for bit, and at the u8 bar against the JAX
    stream under the same switch."""
    fast, jfast = fast_pair
    frames = [rng.integers(0, 256, (16, 16, 3), np.uint8) for _ in range(5)]
    _switch(monkeypatch, form)
    outs = list(StreamConverter(fast, batch=2, depth=2, device="cpu")
                .process_frames(frames))
    assert len(outs) == 5
    for k in range(0, 4, 2):
        ref = d2s_host_cmajor(pl.scale2x_batch_u8_fused(
            _to_yuv_batch(torch.from_numpy(np.stack(frames[k:k + 2]))),
            fast).numpy())
        np.testing.assert_array_equal(outs[k], ref[0])
        np.testing.assert_array_equal(outs[k + 1], ref[1])
    jouts = list(jstream.StreamConverter(jfast, batch=2, depth=2)
                 .process_frames(frames))
    _assert_u8_close(np.stack(outs), np.stack([np.asarray(o)
                                               for o in jouts]))


# --- train/qat.py -----------------------------------------------------------

def test_qat_forward_matches_jax(params_np, rng):
    """stack_valid_l6fq within 1e-5 and l6_quant_gap_db within 0.01 dB of
    the JAX functions at precision="highest"."""
    x = rng.random((2, 30, 34, 1), dtype=np.float32)
    params = params_from_numpy(params_np)
    got = qat.stack_valid_l6fq(torch.from_numpy(x), params)
    ref = np.asarray(jqat.stack_valid_l6fq(jnp.asarray(x), params_np,
                                           precision="highest"))
    assert got.shape == (2, 16, 20, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    plain = np.asarray(jconv_stack_valid(jnp.asarray(x), params_np,
                                         precision="highest"))
    assert not np.allclose(got.numpy(), plain, rtol=0, atol=1e-5)
    gap = qat.l6_quant_gap_db(params, torch.from_numpy(x))
    assert abs(gap - jqat.l6_quant_gap_db(params_np, jnp.asarray(x))) <= 0.01
    assert 20.0 < gap < 80.0


def test_qat_straight_through_gradient():
    """_fq passes the gradient of the identity; the scale gets none."""
    v = torch.linspace(-1, 1, 11, requires_grad=True)
    s = torch.tensor(0.05, requires_grad=True)
    out = qat._fq(v, s)
    assert torch.allclose(out, torch.round(v / 0.05).clamp(-127, 127) * 0.05)
    out.sum().backward()
    assert torch.equal(v.grad, torch.ones(11)) and s.grad is None
