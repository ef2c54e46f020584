"""Layer 7 of the f32 stacks as the folded tap product (csrc/l7.cu's
l7_fold_f32, FFMA) on the CPU: every f32 stack's plain version ends in its
plain version (stack.l7_fold_plain) and agrees with the JAX f32 kernel in
interpret mode in the scale, noise, dense and u8 forms; the three output
forms alone; and which C entry each layer-7 call reaches, for a whole
stack call too (a fake library stands in for the card, so every launch of
stack._launch runs here and is recorded).

Bars: f32 within 3e-5 (the JAX kernel suite's); dense un-chunked equal to
s2d bit for bit (one Y, two layouts); u8 equal except |diff| <= 1 at < 0.2%
of bytes, where the two sides take their f32 sums in another order before
the final rounding. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py (phase 24)."""

import contextlib

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
from waifu2x_torch.config import Config
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack

torch.set_num_threads(2)

TILE = (16, 16)
GUARD = [(1, 27, 38), (2, 37, 53), (1, 5, 300)]
IDS = [str(s) for s in GUARD]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture
def folds(monkeypatch):
    """Records every Y that l7_fold_plain returns (the f32 Y before any
    output form)."""
    seen = []
    plain = stack.l7_fold_plain

    def spy(*args):
        seen.append(plain(*args))
        return seen[-1]

    monkeypatch.setattr(stack, "l7_fold_plain", spy)
    return seen


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


# --- the f32 stacks against the JAX kernel -----------------------------------

@pytest.mark.parametrize("shape", GUARD, ids=IDS)
def test_f32_scale_stack_ends_in_the_fold(params_np, sp32, rng, folds,
                                          shape):
    """stack_scale in f32 is l7_fold_plain's Y of its layer-6 plane, and
    within 3e-5 of the JAX f32 kernel (layer 7 folded there too)."""
    ylow = rng.random(shape, dtype=np.float32)
    got = stack.stack_scale(torch.from_numpy(ylow), sp32)
    assert len(folds) == 1 and torch.equal(got, folds[0])
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jps.stack_scale(jnp.asarray(ylow), kp, spec, tile=TILE,
                                     interpret=True))
    assert got.shape == (*shape, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("shape", GUARD, ids=IDS)
def test_f32_noise_stack_ends_in_the_fold(params_np, sp32, rng, folds,
                                          shape):
    """stack_noise in f32 (any plane size, run on the plane rounded up to
    even) is l7_fold_plain's Y interleaved and cropped, and within 3e-5 of
    the JAX f32 kernel."""
    y = rng.random(shape, dtype=np.float32)
    n, h, w = shape
    got = stack.stack_noise(torch.from_numpy(y), sp32)
    assert len(folds) == 1
    assert torch.equal(got, s2d.d2s(folds[0])[..., 0][:, :h, :w])
    kp, spec = jps.prep_params(params_np, scale_input=False,
                               dtype=jnp.float32)
    ref = np.asarray(jps.stack_noise(jnp.asarray(y), kp, spec, tile=TILE,
                                     interpret=True))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("shape", GUARD, ids=IDS)
def test_f32_dense_stack_ends_in_the_fold(params_np, sp32, rng, folds,
                                          shape):
    """stack_scale_dense in f32 un-chunks to stack_scale bit for bit (one
    fold, two layouts), its pad columns zero, and is within 3e-5 of the JAX
    kernel's dense form un-chunked (the port's chunk is a multiple of 32
    columns, JAX's its tile's)."""
    ylow = rng.random(shape, dtype=np.float32)
    n, hl, wl = shape
    t = torch.from_numpy(ylow)
    ydense, tc = stack.stack_scale_dense(t, sp32)
    assert len(folds) == 1
    assert torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), folds[0])
    assert torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl),
                       stack.stack_scale(t, sp32))
    nx = -(-wl // tc)
    chunks = ydense.reshape(n, hl, nx, 4, tc)
    assert not chunks[:, :, -1, :, wl - (nx - 1) * tc:].any()
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    jdense, jtc = jps.stack_scale_dense(jnp.asarray(ylow), kp, spec, TILE,
                                        interpret=True)
    np.testing.assert_allclose(
        stack.dense_to_s2d(ydense, tc, hl, wl).numpy(),
        np.asarray(jps.dense_to_s2d(jdense, jtc, hl, wl)), rtol=0, atol=3e-5)


@pytest.mark.parametrize("shape", GUARD, ids=IDS)
def test_f32_u8_stack_ends_in_the_fold(params_np, sp32, rng, folds,
                                       monkeypatch, shape):
    """stack_scale_fused_u8 in f32 is the colour map of the fold's f32 Y,
    lanes 12:16 zero, and the JAX kernel's fused u8 epilogue (f32 U/V
    phases) within one level at under 0.2% of bytes."""
    n, h, w = shape
    yuv = rng.random((n, h, w, 3), dtype=np.float32)
    t = torch.from_numpy(yuv)
    uvp = pl._uv_phases_cmajor(t)
    got = stack.stack_scale_fused_u8(t[..., 0].contiguous(), uvp, sp32)
    assert len(folds) == 1
    chans = stack.combine_u8_cmajor(folds[0], uvp[..., 0:4], uvp[..., 4:8])
    assert torch.equal(got[..., :12], torch.cat(chans, dim=-1))
    assert got.shape == (n, h, w, 16) and not got[..., 12:].any()
    monkeypatch.setattr(jps, "UVP_MODE", "f32")
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jps.stack_scale_fused_u8(
        jnp.asarray(yuv[..., 0]), jpl._uv_phases_cmajor(jnp.asarray(yuv),
                                                        TILE),
        kp, spec, TILE, interpret=True))
    _assert_u8_close(got.numpy(), ref)


# --- layer 7 alone -----------------------------------------------------------

def _x6(shape, seed):
    n, hl, wl = shape
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 2 * hl + 2, 2 * wl + 2, 128)).astype(np.float32))


@pytest.mark.parametrize("shape,tc", [((1, 5, 70), None), ((1, 5, 70), 32),
                                      ((2, 7, 9), None)])
def test_f32_last_layer_forms(sp32, shape, tc):
    """last_layer on an f32 plane: s2d is the fold's Y, dense un-chunked is
    s2d bit for bit with zero pad columns, u8 the colour map of the same
    f32 Y (lanes 12:16 zero)."""
    n, hl, wl = shape
    x6 = _x6(shape, sum(shape))
    y = stack.l7_fold_plain(x6, sp32.w7f, sp32[6][1])
    s2d_y = stack.last_layer(x6, sp32)
    assert torch.equal(s2d_y, y)
    ydense, tc_out = stack.last_layer(x6, sp32, out="dense", tc=tc)
    assert tc_out % 32 == 0 and (tc is None or tc_out == tc)
    assert torch.equal(stack.dense_to_s2d(ydense, tc_out, hl, wl), s2d_y)
    nx = -(-wl // tc_out)
    chunks = ydense.reshape(n, hl, nx, 4, tc_out)
    assert not chunks[:, :, -1, :, wl - (nx - 1) * tc_out:].any()
    uvp = torch.from_numpy(np.random.default_rng(2).random(
        (n, hl, wl, 8), dtype=np.float32))
    got = stack.last_layer(x6, sp32, out="u8", uvp=uvp)
    chans = stack.combine_u8_cmajor(y, uvp[..., 0:4], uvp[..., 4:8])
    assert torch.equal(got[..., :12], torch.cat(chans, dim=-1))
    assert not got[..., 12:].any()


def test_f32_fold_reads_w7_itself(sp32):
    """The f32 kernel reads w7's taps, not w7f: every entry of w7f that is
    not zero is one of them, and a bare tuple of f32 weights gets the same
    w7f packed from the stored w7."""
    w7 = sp32[6][0][:, :, 0]                                  # [128, 9]
    nonzero = sp32.w7f[sp32.w7f != 0]
    assert nonzero.numel() == 4 * 9 * 128
    assert set(nonzero.tolist()) <= set(w7.flatten().tolist())
    x6 = _x6((1, 2, 3), 4)
    assert torch.equal(stack._w7f(tuple(sp32), x6), sp32.w7f)
    assert torch.equal(stack.last_layer(x6, tuple(sp32)),
                       stack.last_layer(x6, sp32))


def test_default_conversion_runs_the_f32_fold():
    """The default Config (noise_scale, compute_dtype auto) builds the noise
    stack in f32, whose layer 7 is the fold: every layer-7 launch is one of
    the fold's two kernels."""
    cfg = Config()
    assert cfg.mode == "noise_scale" and cfg.compute_dtype == "auto"
    assert pl._noise_dtype_for(cfg) == torch.float32
    assert set(stack.L7_LAUNCHES) == {"fold", "fold_f32"}


# --- the dispatch of whole stack calls ---------------------------------------

class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """stack._launch on CPU tensors as on the card: every _Launcher's
    libraries are fakes that record their calls (returned), and
    torch.cuda.device is a no-op."""
    calls = []

    def init(self, kind, x, events):
        self.kind, self.events, self.step = kind, events, 0
        self.libs = {name: _FakeLib(calls) for name in stack._ARGTYPES}
        self.bf16 = int(x.dtype == torch.bfloat16)
        self.stream = 0

    monkeypatch.setattr(stack._Launcher, "__init__", init)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    stack.reset_launches()
    yield calls
    stack.reset_launches()


@pytest.mark.parametrize("kind,form,upto,l7_entry,l7_kernel", [
    ("scale", "direct", None, "w2x_l7_fold", "fold_f32"),
    ("noise", "direct", None, "w2x_l7_fold", "fold_f32"),
    ("dense", "direct", None, "w2x_l7_fold", "fold_f32"),
    ("fused_u8", "direct", None, "w2x_l7_fold", "fold_f32"),
    ("scale", "wino", None, "w2x_l7_fold", "fold_f32"),
    ("scale", "i8", None, "w2x_l7_fold", "fold_f32"),
    ("fused_u8", "i8", None, "w2x_l7_fold", "fold_f32"),
    ("scale", "direct", 6, "w2x_l7_fold", "fold_f32")],
    ids=["scale", "noise", "dense", "u8", "wino", "i8", "i8-u8", "taps"])
def test_f32_stack_dispatch(sp32, fake_card, kind, form, upto, l7_entry,
                            l7_kernel):
    """A whole f32 stack call's last launch: the fold (csrc/l7.cu, counted
    under L7_LAUNCHES["fold_f32"], with w7's taps and bf16 = 0) on every
    plane and on the int8 layer's tile-major planes (with their tiling),
    and the truncation's taps as the fold's tap form (OUT_TAPS)."""
    n, h, w = 1, 20, 36
    x = torch.zeros((n, h, w))
    uvp = torch.zeros((n, h // 2 if kind == "noise" else h,
                       w // 2 if kind == "noise" else w, 8))
    stack._launch(x, sp32, kind, None, uvp=uvp if kind == "fused_u8" else None,
                  tc=32 if kind == "dense" else 0, form=form,
                  tile=(8, 16) if form == "i8" else None, upto=upto)
    fn, args = fake_card[-1]
    assert fn == l7_entry
    want = {k: 0 for k in stack.L7_LAUNCHES}
    want[l7_kernel] = 1
    assert stack.L7_LAUNCHES == want
    if fn == "w2x_l7_fold":
        # (bf16, x6, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
        #  tr, tc, ny, nx, zs, stream)
        assert args[0] == 0 and args[2] == sp32[6][0].data_ptr()
        assert args[16] == 0
        hl, wl = (h // 2, w // 2) if kind == "noise" else (h, w)
        mode = stack._OUT_TAPS if upto == 6 else stack._OUT_MODES[kind]
        assert args[5:9] == (n, hl, wl, mode)
        assert args[12:16] == ((8, 16, 3, 3) if form == "i8" else (0,) * 4)


@pytest.mark.parametrize("zs", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_zero_shift_layer7_takes_the_fold(params_np, fake_card, dtype, zs):
    """A zero-shift mask takes the fold (w2x_l7_fold with the mask, in both
    types: bf16 with w7f, f32 with w7's taps), counted under
    L7_LAUNCHES["fold"] or ["fold_f32"] and under no layer-6 key."""
    stack.reset_launches()
    sp = stack.prep_params(params_from_numpy(params_np), dtype, "cpu")
    x6 = torch.zeros((1, 10, 14, 128), dtype=dtype)
    run = stack._Launcher(None, x6, None)
    y = torch.empty((1, 4, 6, 4), dtype=dtype)
    run.layer(6, False, x6, sp, y, 1, 4, 6, zs=zs)
    assert [fn for fn, _ in fake_card] == ["w2x_l7_fold"]
    args = fake_card[0][1]
    bf16 = dtype == torch.bfloat16
    # (bf16, x6, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
    #  tr, tc, ny, nx, zs, stream)
    assert args[0] == int(bf16)
    assert args[2] == (sp.w7f if bf16 else sp[6][0]).data_ptr()
    assert args[5:9] == (1, 4, 6, 0) and args[12:] == (0, 0, 0, 0, zs, 0)
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16)}
    assert not any(stack.L6_LAUNCHES.values())
    stack.reset_launches()


@pytest.mark.parametrize("form", ["dense", "u8", "tiles"])
def test_masked_fold_refuses_other_forms(sp32, fake_card, form):
    """The fold takes a mask on a plane in s2d layout only: with the dense
    or u8 output, or on the int8 layer's tiles, it raises and launches
    nothing."""
    x6 = torch.zeros((1, 10, 14, 128))
    run = stack._Launcher(None, x6, None)
    y = torch.empty(1)
    kw = {"dense": {"out_mode": stack._OUT_DENSE, "tc": 32},
          "u8": {"out_mode": stack._OUT_U8, "uvp": torch.zeros(1)},
          "tiles": {"tiling": (4, 6, 1, 1)}}[form]
    with pytest.raises(ValueError, match="zero-shift mask"):
        run.l7_fold(x6, sp32, y, 1, 4, 6, zs=2, **kw)
    assert not fake_card
