"""The conv stack's three other configurations on the CPU against the JAX
package: the truncated stack (stack_scale_upto, B7), layer 6 as int8 (l6_i8,
B4) and as Winograd F(2x2, 3x3) (l6_wino, B5); the module switches that
select them on the product paths are held in tests/test_torch_l6_paths.py.
On CPU tensors the wrappers take their plain PyTorch versions; the JAX side runs its Pallas kernel in interpret mode, f32, with
random-init weights, at the JAX suite's own sizes
(tests/test_pallas_stack.py).

Bars, each stated again where it is used: truncation within 3e-5 (the JAX
kernel suite's f32 bar); Winograd within 1e-5 of the JAX kernel and of the
direct form (the JAX bar for the same comparison); int8 against the JAX
kernel at one tile geometry within a tenth of what int8 itself costs (rms
and max), because a quantiser tie that the f32 summation order of layers
1-5 flips moves one int8 step. The CUDA kernels themselves are held against
the plain versions on the card by chip_smoke.py."""

import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_tpu.ops import s2d as js2d
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def kp(params_np):
    return jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)


@pytest.fixture(scope="module")
def kp_noise(params_np):
    return jps.prep_params(params_np, scale_input=False, dtype=jnp.float32)


def jscale(ylow, kp, tile, **kw):
    """The JAX kernel on the scale im2col, interpret mode, cropped from its
    tile grid -> numpy [N, hl, wl, 4]."""
    arrays, spec = kp
    (tr, tc), (_, hl, wl) = tile, ylow.shape
    ny, nx = -(-hl // tr), -(-wl // tc)
    xcol = jps._xcol_scale(jnp.asarray(ylow), tr, tc)
    out = jps._run_stack(xcol, arrays, tr, tc, ny, nx, spec, interpret=True,
                         **kw)
    return np.asarray(out)[:, :hl, :wl]


def jnoise(y, kp_noise, tile, **kw):
    """The JAX kernel on the noise im2col of y edge-padded to even ->
    numpy [N, ceil(h/2), ceil(w/2), 4]."""
    arrays, spec = kp_noise
    (tr, tc), (_, h, w) = tile, y.shape
    y = np.pad(y, ((0, 0), (0, h % 2), (0, w % 2)), mode="edge")
    hl, wl = y.shape[1] // 2, y.shape[2] // 2
    ny, nx = -(-hl // tr), -(-wl // tc)
    xcol = jps._xcol_noise(jnp.asarray(y), tr, tc)
    out = jps._run_stack(xcol, arrays, tr, tc, ny, nx, spec, interpret=True,
                         **kw)
    return np.asarray(out)[:, :hl, :wl]


def _rms(d):
    return float(np.sqrt((np.asarray(d, np.float64) ** 2).mean()))


# --- weights ----------------------------------------------------------------

def test_pack_wino_bit_equal(rng):
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(s2d.pack_wino(w), js2d.pack_wino(w))
    np.testing.assert_array_equal(s2d._WINO_G, js2d._WINO_G)
    assert s2d._WINO_BT_TAPS == js2d._WINO_BT_TAPS
    assert s2d._WINO_AT == js2d._WINO_AT
    with pytest.raises(ValueError, match="3x3"):
        s2d.pack_wino(w[:2])


def test_prep_params_l6_forms(params_np, sp32):
    """w6q and w6s against pack_for_kernels (whose four phase packs each
    hold all 9 taps: their scales are equal rows, and their rows are found
    by packing a tensor of row indices the same way); w6w against
    pack_wino."""
    arrays, _ = jps.pack_for_kernels(params_np, True)
    for p in range(4):
        np.testing.assert_array_equal(sp32.w6s.numpy(), arrays["w6s"][p])
    q = stack.unpack_w6q(sp32.w6q).numpy()          # [ci, tap, co]
    assert q.dtype == np.int8 and np.abs(q).max() == 127
    index = np.broadcast_to(
        np.arange(9 * 128, dtype=np.float32).reshape(3, 3, 128, 1),
        (3, 3, 128, 128))                           # tap * 128 + ci
    rows, _ = jps.pack_mid_kernel(index)
    for p in range(4):
        tap, ci = np.divmod(rows[p, :, 0].astype(int), 128)
        np.testing.assert_array_equal(q[ci, tap], arrays["w6q"][p])
    assert sp32.w6q.dtype == torch.int32 and sp32.w6q.shape == (32, 9, 128)
    np.testing.assert_array_equal(sp32.w6w.numpy(), arrays["w6w"])
    sp16 = stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")
    assert sp16.w6w.dtype == torch.bfloat16
    assert torch.equal(sp16.w6q, sp32.w6q) and len(sp16) == 7


def test_default_tile():
    """The grid cut evenly into the fewest tiles of at most 64 x 128."""
    assert stack.default_tile(256, 256) == (64, 128)
    assert stack.default_tile(13, 22) == (13, 22)
    assert stack.default_tile(540, 960) == (60, 120)
    assert stack.default_tile(65, 129) == (33, 65)


# --- B7: the truncated stack ------------------------------------------------

@pytest.mark.parametrize("shape,tile", [((1, 16, 16), (16, 16)),
                                        ((2, 13, 22), (8, 16))],
                         ids=["16x16", "13x22-grid2x2"])
@pytest.mark.parametrize("upto", range(7))
def test_upto_matches_pallas_interpret(kp, sp32, rng, shape, tile, upto):
    """Within 3e-5, the JAX suite's f32 bar. upto=0: the JAX body adds one
    sum over the neighbour blocks to a whole tile, a constant the port
    leaves out; it is under 512 at these tiles, so adding it rounds each
    value by up to half an f32 unit there (1.53e-5), and the difference to
    the tile's median lies within twice that."""
    ylow = rng.random(shape, dtype=np.float32)
    ref = jscale(ylow, kp, tile, upto=upto)
    got = stack.stack_scale_upto(torch.from_numpy(ylow), sp32, upto)
    assert got.shape == (*shape, 4) and got.dtype == torch.float32
    if upto:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
        return
    diff = ref - got.numpy()
    tr, tc = tile
    for n in range(shape[0]):
        for i in range(0, shape[1], tr):
            for j in range(0, shape[2], tc):
                d = diff[n, i:i + tr, j:j + tc]
                assert np.abs(d - np.median(d)).max() <= 3.1e-5


@pytest.mark.parametrize("form", ["i8", "wino"])
def test_upto6_follows_layer6_form(kp, sp32, rng, form):
    """upto=6 is taken after layer 6 in the selected form: Winograd within
    3e-5 of the JAX kernel, int8 within a tenth of the JAX int8's distance
    to the JAX default (see test_i8_matches_pallas_interpret)."""
    ylow = rng.random((1, 13, 22), dtype=np.float32)
    kw = {"l6_" + form: True}
    ref = jscale(ylow, kp, (8, 16), upto=6, **kw)
    got = stack.stack_scale_upto(torch.from_numpy(ylow), sp32, 6,
                                 tile=(8, 16), **kw).numpy()
    if form == "wino":
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    else:
        cost = ref - jscale(ylow, kp, (8, 16), upto=6)
        assert np.abs(got - ref).max() <= 0.1 * np.abs(cost).max()
        assert _rms(got - ref) <= 0.1 * _rms(cost)


def test_upto_rejects_bad_layer(sp32):
    y = torch.rand(1, 8, 8)
    for bad in (-1, 7, 2.5, None):
        with pytest.raises(ValueError, match="upto"):
            stack.stack_scale_upto(y, sp32, bad)


# --- B5: Winograd layer 6 ---------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 13, 22)],
                         ids=["32x32", "13x22"])
def test_wino_scale_matches_pallas_interpret(kp, sp32, rng, shape):
    """Within 1e-5 of the JAX kernel under l6_wino and of the port's direct
    form: the JAX suite's bar for Winograd against phase-sparse."""
    ylow = rng.random(shape, dtype=np.float32)
    t = torch.from_numpy(ylow)
    got = stack.stack_scale(t, sp32, l6_wino=True).numpy()
    np.testing.assert_allclose(got, jscale(ylow, kp, (16, 16), l6_wino=True),
                               rtol=0, atol=1e-5)
    direct = stack.stack_scale(t, sp32, l6_wino=False).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-5)
    assert not np.array_equal(got, direct)


@pytest.mark.parametrize("shape", [(1, 32, 32), (1, 27, 38)],
                         ids=["32x32", "27x38"])
def test_wino_noise_matches_pallas_interpret(kp_noise, sp32, rng, shape):
    y = rng.random(shape, dtype=np.float32)
    t = torch.from_numpy(y)
    ref = jnoise(y, kp_noise, (16, 16), l6_wino=True)
    if shape[1] % 2 == 0:
        got = stack.stack_noise_s2d(t, sp32, l6_wino=True).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    got = stack.stack_noise(t, sp32, l6_wino=True).numpy()
    want = np.asarray(js2d.d2s(jnp.asarray(ref)))[:, :shape[1], :shape[2], 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, stack.stack_noise(t, sp32).numpy(),
                               rtol=0, atol=1e-5)


def test_wino_other_output_forms(sp32, rng):
    """The dense and u8 forms under l6_wino come from the same Y."""
    yuv = torch.from_numpy(rng.random((1, 9, 11, 3), dtype=np.float32))
    y = yuv[..., 0].contiguous()
    ys = stack.stack_scale(y, sp32, l6_wino=True)
    ydense, tc = stack.stack_scale_dense(y, sp32, l6_wino=True)
    assert torch.equal(stack.dense_to_s2d(ydense, tc, 9, 11), ys)
    uvp = pl._uv_phases_cmajor(yuv)
    u8 = stack.stack_scale_fused_u8(y, uvp, sp32, l6_wino=True)
    ref = stack.stack_scale_fused_u8(y, uvp, sp32)
    assert u8.shape == (1, 9, 11, 16) and not u8[..., 12:].any()
    assert (u8.int() - ref.int()).abs().max() <= 1


def test_wino_bf16_fidelity(params_np, sp32, rng):
    """bf16 storage with U rounded to bf16: >= 50 dB (peak 1) against the
    f32 direct form on an image-like plane with random-init weights."""
    yy, xx = np.mgrid[0:24, 0:40].astype(np.float32)
    ylow = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
            + 0.02 * rng.standard_normal((24, 40))).astype(np.float32)[None]
    sp16 = stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")
    y32 = stack.stack_scale(torch.from_numpy(ylow), sp32)
    y16 = stack.stack_scale(torch.from_numpy(ylow).to(torch.bfloat16), sp16,
                            l6_wino=True)
    assert y16.dtype == torch.bfloat16
    mse = torch.mean((y16.double() - y32.double()) ** 2).item()
    assert 10 * np.log10(1.0 / mse) >= 50.0


# --- B4: int8 layer 6 -------------------------------------------------------

I8_CASES = [((1, 16, 16), (16, 16)), ((1, 32, 32), (16, 16)),
            ((1, 13, 22), (8, 16))]
I8_IDS = ["one-tile", "grid2x2", "grid-pads"]


def _assert_i8_close(got, ref_i8, ref_default, got_default):
    """Port int8 against JAX int8 at the same tiles: rms and max of the
    difference each at most a tenth of the rms and max between JAX int8 and
    JAX default on the same input. (The quantised values and the int32 sums
    agree except where the f32 summation order of layers 1-5 moves an
    activation across a rounding tie of the quantiser; one such flip moves
    one int8 step and spreads over the windows of layers 6 and 7. The JAX
    kernel also adds its int32 partials in f32, which is exact while the
    total stays under 2^24.) Port int8 against port default inside the JAX
    suite's envelope for the same comparison: max < 0.15, rms < 0.03."""
    assert np.isfinite(got).all()
    cost = ref_i8 - ref_default
    assert np.abs(got - ref_i8).max() <= 0.1 * np.abs(cost).max()
    assert _rms(got - ref_i8) <= 0.1 * _rms(cost)
    own = got - got_default
    assert 0 < np.abs(own).max() < 0.15 and _rms(own) < 0.03


@pytest.mark.parametrize("shape,tile", I8_CASES, ids=I8_IDS)
def test_i8_matches_pallas_interpret(kp, sp32, rng, shape, tile):
    ylow = rng.random(shape, dtype=np.float32)
    t = torch.from_numpy(ylow)
    got = stack.stack_scale(t, sp32, l6_i8=True, tile=tile)
    assert got.shape == (*shape, 4) and got.dtype == torch.float32
    _assert_i8_close(got.numpy(), jscale(ylow, kp, tile, l6_i8=True),
                     jscale(ylow, kp, tile), stack.stack_scale(t, sp32).numpy())


@pytest.mark.parametrize("shape,tile", [((1, 32, 32), (8, 16)),
                                        ((1, 27, 38), (8, 16))],
                         ids=["32x32-grid2x1", "27x38-grid-pads"])
def test_i8_noise_matches_pallas_interpret(kp_noise, sp32, rng, shape, tile):
    """The noise path extends the full-res plane to the tile grid; an odd
    plane's pad to even is part of the same edge extension."""
    y = rng.random(shape, dtype=np.float32)
    t = torch.from_numpy(y)
    ref_i8 = jnoise(y, kp_noise, tile, l6_i8=True)
    ref = jnoise(y, kp_noise, tile)
    h, w = shape[1:]
    got = s2d.s2d(torch.nn.functional.pad(
        stack.stack_noise(t, sp32, l6_i8=True, tile=tile)[:, None],
        (0, w % 2, 0, h % 2), mode="replicate")[:, 0, :, :, None]).numpy()
    got_default = s2d.s2d(torch.nn.functional.pad(
        stack.stack_noise(t, sp32)[:, None],
        (0, w % 2, 0, h % 2), mode="replicate")[:, 0, :, :, None]).numpy()
    # an odd plane's pad row and column are no output of the port: hold
    # the cells that lie inside the plane
    keep = np.zeros(got.shape, bool)
    for a in (0, 1):
        for b in (0, 1):
            keep[:, :(h - a + 1) // 2, :(w - b + 1) // 2, a * 2 + b] = True
    _assert_i8_close(got[keep], ref_i8[keep], ref[keep], got_default[keep])
    if h % 2 == 0 and w % 2 == 0:
        np.testing.assert_array_equal(
            stack.stack_noise_s2d(t, sp32, l6_i8=True, tile=tile).numpy(),
            got)


def test_i8_tiles_have_their_own_scale(sp32, rng):
    """A bright patch raises one tile's scale only: the tiles that do not
    see it keep their output bit for bit, the plane as one tile does not."""
    ylow = 0.2 * rng.random((1, 16, 32), dtype=np.float32)
    bright = ylow.copy()
    bright[0, 4:8, 24:28] += 3.0
    a, b = (stack.stack_scale(torch.from_numpy(y), sp32, l6_i8=True,
                              tile=(16, 16)) for y in (ylow, bright))
    assert torch.equal(a[:, :, :8], b[:, :, :8])      # 9+ cells from the patch
    assert not torch.equal(a[:, :, 16:], b[:, :, 16:])
    one_a, one_b = (stack.stack_scale(torch.from_numpy(y), sp32, l6_i8=True,
                                      tile=(16, 32)) for y in (ylow, bright))
    assert not torch.equal(one_a[:, :, :8], one_b[:, :, :8])


def test_i8_layer_step_agrees_with_the_stack(sp32, rng):
    """l6_i8_layer on the stored layer-5 plane (layer5_plane: the plane
    edge-extended to the 2 x 2 tile grid), then layer 7 per tile,
    gives stack_scale(l6_i8=True) within 2e-6 (the same quantised values
    and exact sums; layer 7's f32 sums run over another memory layout); sx
    is max |x5| / 127 over each tile's window."""
    tile, (hl, wl) = (8, 16), (13, 22)
    ylow = torch.from_numpy(rng.random((2, hl, wl), dtype=np.float32))
    want = stack.stack_scale(ylow, sp32, l6_i8=True, tile=tile)
    x5 = stack.layer5_plane(ylow, sp32, tile)
    assert x5.shape == (2, 36, 68, 128) and x5.is_contiguous()
    x6t, sx = stack.l6_i8_layer(x5, sp32, tile)
    assert x6t.shape == (2, 2, 2, 18, 34, 128) and sx.shape == (2, 2, 2)
    got = torch.empty(2, 16, 32, 4)
    for ti in range(2):
        for tj in range(2):
            win = x5[:, 16 * ti:16 * ti + 20, 32 * tj:32 * tj + 36]
            np.testing.assert_allclose(
                sx[:, ti, tj].numpy(),
                win.abs().amax(dim=(1, 2, 3)).numpy() / 127, rtol=1e-6)
            y = stack._plain_layer(x6t[:, ti, tj].permute(0, 3, 1, 2),
                                   *sp32[6], torch.float32)
            got[:, 8 * ti:8 * ti + 8, 16 * tj:16 * tj + 16] = s2d.s2d(
                y[:, 0, :, :, None])
    torch.testing.assert_close(got[:, :hl, :wl], want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="x5"):
        stack.l6_i8_layer(x5[:, :-1].contiguous(), sp32, tile)


def test_i8_other_output_forms_and_bf16(params_np, sp32, rng):
    yuv = torch.from_numpy(rng.random((1, 9, 11, 3), dtype=np.float32))
    y = yuv[..., 0].contiguous()
    ys = stack.stack_scale(y, sp32, l6_i8=True)
    ydense, tc = stack.stack_scale_dense(y, sp32, l6_i8=True)
    assert torch.equal(stack.dense_to_s2d(ydense, tc, 9, 11), ys)
    uvp = pl._uv_phases_cmajor(yuv)
    u8 = stack.stack_scale_fused_u8(y, uvp, sp32, l6_i8=True)
    assert u8.shape == (1, 9, 11, 16) and not u8[..., 12:].any()
    sp16 = stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")
    y16 = stack.stack_scale(y.to(torch.bfloat16), sp16, l6_i8=True)
    assert y16.dtype == torch.bfloat16 and torch.isfinite(y16.float()).all()
    # bf16 storage moves the int8 result by less than int8 itself does
    assert (y16.float() - ys).abs().max() < 0.15


WRAPPER_CALLS = {
    "stack_scale": lambda y, uvp, sp, kw: stack.stack_scale(y, sp, **kw),
    "stack_scale_plain": lambda y, uvp, sp, kw: stack.stack_scale_plain(
        y, sp, **kw),
    "stack_scale_dense": lambda y, uvp, sp, kw: stack.stack_scale_dense(
        y, sp, **kw),
    "stack_scale_fused_u8": lambda y, uvp, sp, kw:
        stack.stack_scale_fused_u8(y, uvp, sp, **kw),
    "stack_scale_upto": lambda y, uvp, sp, kw: stack.stack_scale_upto(
        y, sp, 6, **kw),
    "stack_noise_s2d": lambda y, uvp, sp, kw: stack.stack_noise_s2d(
        y, sp, **kw),
    "stack_noise": lambda y, uvp, sp, kw: stack.stack_noise(y, sp, **kw),
    "stack_noise_plain": lambda y, uvp, sp, kw: stack.stack_noise_plain(
        y, sp, **kw),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_l6_forms_are_mutually_exclusive(sp32, monkeypatch, name):
    """Both arguments, or both module switches, raise as the JAX kernel
    does; a plain tuple of weights cannot select a form it has no weights
    for; a bad tile raises."""
    y, uvp = torch.rand(1, 8, 8), torch.rand(1, 8, 8, 8)
    call = WRAPPER_CALLS[name]
    with pytest.raises(ValueError, match="mutually exclusive"):
        call(y, uvp, sp32, {"l6_i8": True, "l6_wino": True})
    monkeypatch.setattr(stack, "L6_I8", True)
    monkeypatch.setattr(stack, "L6_WINO", True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        call(y, uvp, sp32, {})
    monkeypatch.setattr(stack, "L6_WINO", False)
    with pytest.raises(ValueError, match="prep_params"):
        call(y, uvp, tuple(sp32), {})
    with pytest.raises(ValueError, match="tile"):
        call(y, uvp, sp32, {"tile": (0, 16)})
    call(y, uvp, tuple(sp32), {"l6_i8": False})      # the direct form


@pytest.mark.parametrize("var,attr", [("W2X_L6_I8", "L6_I8"),
                                      ("W2X_L6_WINO", "L6_WINO")])
def test_l6_env_switches(monkeypatch, var, attr):
    """The module reads the JAX package's two variables when it is
    imported. Run from source into a fresh namespace, so the imported
    module is untouched."""
    assert stack.L6_I8 is False and stack.L6_WINO is False
    monkeypatch.setenv(var, "1")
    ns = runpy.run_path(stack.__file__)
    assert ns[attr] is True
    assert ns["L6_WINO" if attr == "L6_I8" else "L6_I8"] is False
    monkeypatch.setenv(var, "0")
    assert runpy.run_path(stack.__file__)[attr] is False


def test_no_launches_on_cpu(sp32):
    before = stack.LAUNCHES
    y = torch.rand(1, 6, 7)
    stack.stack_scale(y, sp32, l6_i8=True)
    stack.stack_scale(y, sp32, l6_wino=True)
    stack.stack_scale_upto(y, sp32, 3)
    assert stack.LAUNCHES == before == 0
    assert set(stack.L6_LAUNCHES) == {"direct", "i8", "wino", "upto"}
    assert not any(stack.L6_LAUNCHES.values())
    assert set(stack.KERNEL_LAUNCHES) == {"scale", "noise", "dense",
                                          "fused_u8", "probe"}
