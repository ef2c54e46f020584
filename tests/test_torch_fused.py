"""The scale step's two other kernel configurations on the CPU against the
JAX package: the in-kernel u8 tail (stack_scale_fused_u8, W2X_TAIL=kernel)
and the dense Y output (stack_scale_dense, W2X_YDENSE=1), with the pipeline
switches that select them. On CPU tensors the wrappers take their plain
PyTorch versions; the JAX side runs its Pallas kernel in interpret mode, f32,
tile (16, 16), as tests/test_fastpath.py builds it.

Bars: u8 outputs equal except |diff| <= 1 on < 0.5% of bytes where the two
sides take their f32 sums in another order before the final rounding
(tests/test_fastpath.py:81-97); lanes 12:16 zero; layout functions and
banding exact; the polyphase U/V within 1e-6. The CUDA kernel itself is
held against the plain versions on the card by chip_smoke.py."""

import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import stack

torch.set_num_threads(2)

TILE = (16, 16)
SETTINGS = [("xla", False), ("xla", True), ("kernel", False)]
SETTING_IDS = ["xla", "xla-ydense", "kernel"]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(11), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def fast(params_np):
    return pl.FastStack.build(params_from_numpy(params_np), True,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jfast(params_np):
    return jpl.FastStack.build(params_np, scale_input=True, tile=TILE,
                               interpret=True, dtype=jnp.float32)


def _set_tail(monkeypatch, tail, ydense):
    for mod in (pl, jpl):
        monkeypatch.setattr(mod, "FUSED_TAIL", tail)
        monkeypatch.setattr(mod, "YDENSE", ydense)


def _assert_u8_close(got, ref, frac=0.005):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


# --- the wrappers (ops/stack.py) --------------------------------------------

@pytest.mark.parametrize("shape", [(2, 18, 20), (1, 13, 22)])
def test_fused_u8_matches_pallas_interpret(params_np, sp32, rng, monkeypatch,
                                           shape):
    """|diff| <= 1 at under 0.5% of bytes against the JAX kernel with f32
    U/V phases; lanes 12:16 zero."""
    n, h, w = shape
    yuv = rng.random((n, h, w, 3), dtype=np.float32)
    monkeypatch.setattr(jps, "UVP_MODE", "f32")
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    juvp = jpl._uv_phases_cmajor(jnp.asarray(yuv), TILE)
    ref = np.asarray(jps.stack_scale_fused_u8(
        jnp.asarray(yuv[..., 0]), juvp, kp, spec, TILE, interpret=True))
    t = torch.from_numpy(yuv)
    uvp = pl._uv_phases_cmajor(t)
    got = stack.stack_scale_fused_u8(t[..., 0].contiguous(), uvp, sp32)
    assert got.shape == (n, h, w, 16) and got.dtype == torch.uint8
    assert not got[..., 12:].any()
    _assert_u8_close(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 18, 20), (1, 13, 22), (1, 5, 7)])
def test_uv_phases_cmajor_matches_jax(rng, shape):
    """Against the JAX function cropped from its tile grid: within 1e-6
    (the two frameworks may order the 4-tap sums differently)."""
    n, h, w = shape
    yuv = rng.random((n, h, w, 3), dtype=np.float32)
    ref = np.asarray(jpl._uv_phases_cmajor(jnp.asarray(yuv), TILE))
    got = pl._uv_phases_cmajor(torch.from_numpy(yuv))
    assert got.shape == (n, h, w, 8) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref[:, :h, :w], rtol=0, atol=1e-6)


def test_dense_to_s2d_matches_jax(params_np, sp32, rng):
    """dense_to_s2d on the array the JAX stack_scale_dense returns, with
    JAX's tc: equal to the JAX dense_to_s2d, and within the f32 stack bar
    (3e-5) of the port's stack_scale."""
    y = rng.random((2, 18, 20), dtype=np.float32)
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    jdense, jtc = jps.stack_scale_dense(jnp.asarray(y), kp, spec, TILE,
                                        interpret=True)
    ref = np.asarray(jps.dense_to_s2d(jdense, jtc, 18, 20))
    got = stack.dense_to_s2d(torch.from_numpy(np.array(jdense)), jtc, 18, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    ours = stack.stack_scale(torch.from_numpy(y), sp32)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tc", [((2, 16, 16), None), ((2, 13, 22), None),
                                      ((1, 5, 70), None), ((1, 5, 70), 32)])
def test_dense_unchunked_equals_stack_scale(params_np, rng, dtype, shape,
                                            tc):
    """stack_scale_dense un-chunked is stack_scale bit for bit; the pad
    columns of the last chunk read zero; s2d_to_dense inverts."""
    sp = stack.prep_params(params_from_numpy(params_np), dtype, "cpu")
    n, hl, wl = shape
    y = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dtype)
    ydense, tc_out = stack.stack_scale_dense(y, sp, tc)
    assert tc_out % 32 == 0 and (tc is None or tc_out == tc)
    nx = -(-wl // tc_out)
    assert ydense.shape == (n, hl, nx * 4 * tc_out) and ydense.dtype == dtype
    want = stack.stack_scale(y, sp)
    torch.testing.assert_close(stack.dense_to_s2d(ydense, tc_out, hl, wl),
                               want, rtol=0, atol=0)
    chunks = ydense.reshape(n, hl, nx, 4, tc_out)
    assert not chunks[:, :, -1, :, wl - (nx - 1) * tc_out:].any()
    torch.testing.assert_close(stack.s2d_to_dense(want, tc_out), ydense,
                               rtol=0, atol=0)


def test_new_wrappers_reject_bad_input(sp32):
    y = torch.rand(1, 8, 8)
    uvp = torch.rand(1, 8, 8, 8)
    with pytest.raises(ValueError, match="uvp must be"):
        stack.stack_scale_fused_u8(y, uvp[:, :7], sp32)
    with pytest.raises(TypeError, match="float32"):
        stack.stack_scale_fused_u8(y, uvp.double(), sp32)
    with pytest.raises(ValueError, match="contiguous"):
        stack.stack_scale_fused_u8(
            y, torch.rand(1, 8, 8, 16)[..., ::2], sp32)
    with pytest.raises(TypeError):
        stack.stack_scale_fused_u8(y.double(), uvp, sp32)
    for tc in (0, 48, -32):
        with pytest.raises(ValueError, match="multiple of 32"):
            stack.stack_scale_dense(y, sp32, tc=tc)


def test_fused_u8_keeps_y_in_f32(params_np, rng):
    """In bf16 storage the u8 tail reads the last layer's f32 sum: the
    plain version equals the colour map applied to the stack with its last
    rounding left out, and no CPU call launches anything."""
    sp16 = stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")
    yuv = torch.from_numpy(rng.random((1, 12, 14, 3), dtype=np.float32))
    y16 = yuv[..., 0].to(torch.bfloat16).contiguous()
    uvp = pl._uv_phases_cmajor(yuv)
    before = stack.LAUNCHES
    got = stack.stack_scale_fused_u8(y16, uvp, sp16)
    stack.stack_scale_dense(y16, sp16)
    assert stack.LAUNCHES == before == 0
    assert not any(stack.KERNEL_LAUNCHES.values())
    y_f32 = stack._scale_plain_f32(y16, sp16, round_last=False)
    assert not torch.equal(y_f32, y_f32.to(torch.bfloat16).float())
    want = pl._combine_u8_cmajor(
        y_f32.reshape(1, 12, 56), uvp[..., 0:4].reshape(1, 12, 56),
        uvp[..., 4:8].reshape(1, 12, 56), 1, 12, 14)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- the step under each switch (pipeline.py) -------------------------------

@pytest.mark.parametrize("tail,ydense", SETTINGS, ids=SETTING_IDS)
def test_scale2x_u8_fused_matches_jax(fast, jfast, rng, monkeypatch, tail,
                                      ydense):
    """scale2x_batch_u8_fused under each FUSED_TAIL / YDENSE setting
    against the JAX function under the same setting (f32 U/V phases):
    |diff| <= 1 at under 0.5% of bytes."""
    yuv = rng.random((2, 18, 20, 3), dtype=np.float32)
    _set_tail(monkeypatch, tail, ydense)
    monkeypatch.setattr(jps, "UVP_MODE", "f32")
    ref = np.asarray(jpl.scale2x_batch_u8_fused(jnp.asarray(yuv), jfast))
    got = pl.scale2x_batch_u8_fused(torch.from_numpy(yuv), fast).numpy()
    assert got.shape == (2, 18, 20, 16) and not got[..., 12:].any()
    _assert_u8_close(got, ref)


def test_tails_agree(fast, rng, monkeypatch):
    """YDENSE is bit-equal to the default tail; the kernel tail is within
    one level at under 0.5% of bytes (in f32 it rounds nothing less)."""
    yuv = torch.from_numpy(rng.random((2, 18, 20, 3), dtype=np.float32))
    outs = {}
    for (tail, ydense), name in zip(SETTINGS, SETTING_IDS):
        _set_tail(monkeypatch, tail, ydense)
        outs[name] = pl.scale2x_batch_u8_fused(yuv, fast)
    torch.testing.assert_close(outs["xla-ydense"], outs["xla"],
                               rtol=0, atol=0)
    _assert_u8_close(outs["kernel"].numpy(), outs["xla"].numpy())


@pytest.mark.parametrize("tail,ydense", SETTINGS, ids=SETTING_IDS)
def test_scale2x_u8_fused_banded_and_y_override(fast, rng, monkeypatch, tail,
                                                ydense):
    """150 rows exceed the 64-row band floor: band_rows=16 runs 3 bands,
    equal to the unbanded step, without and with the `y=` override."""
    _set_tail(monkeypatch, tail, ydense)
    yuv = torch.from_numpy(rng.random((1, 150, 12, 3), dtype=np.float32))
    y = torch.from_numpy(rng.random((1, 150, 12), dtype=np.float32))
    assert len(list(pl._bands(150, pl._band_rows(16, 1, 12)))) == 3
    for kw in ({}, {"y": y}):
        whole = pl.scale2x_batch_u8_fused(yuv, fast, band_rows=256, **kw)
        banded = pl.scale2x_batch_u8_fused(yuv, fast, band_rows=16, **kw)
        torch.testing.assert_close(banded, whole, rtol=0, atol=0)
    # the override is what the step converts: y == yuv's own plane
    same = pl.scale2x_batch_u8_fused(yuv, fast, y=yuv[..., 0])
    torch.testing.assert_close(
        same, pl.scale2x_batch_u8_fused(yuv, fast), rtol=0, atol=0)
    assert not torch.equal(whole, same)


def test_fast_stack_methods(fast, rng):
    y = torch.from_numpy(rng.random((1, 9, 11), dtype=np.float32))
    yuv = torch.from_numpy(rng.random((1, 9, 11, 3), dtype=np.float32))
    ydense, tc = fast.scale_dense(y.double())     # cast to the stack dtype
    torch.testing.assert_close(stack.dense_to_s2d(ydense, tc, 9, 11),
                               fast.scale(y), rtol=0, atol=0)
    u8 = fast.scale_fused_u8(y, pl._uv_phases_cmajor(yuv))
    assert u8.shape == (1, 9, 11, 16) and u8.dtype == torch.uint8


@pytest.mark.parametrize("value,ok", [("xla", True), ("kernel", True),
                                      ("bogus", False), ("", False)])
def test_w2x_tail_env(monkeypatch, value, ok):
    """The module reads W2X_TAIL and W2X_YDENSE when it is imported; a bad
    W2X_TAIL raises there. Run from source into a fresh namespace, so the
    imported module is untouched."""
    monkeypatch.setenv("W2X_TAIL", value)
    monkeypatch.setenv("W2X_YDENSE", "1")
    if ok:
        ns = runpy.run_path(pl.__file__)
        assert ns["FUSED_TAIL"] == value and ns["YDENSE"] is True
    else:
        with pytest.raises(ValueError, match="W2X_TAIL"):
            runpy.run_path(pl.__file__)
    assert pl.FUSED_TAIL in ("xla", "kernel")
