"""Layer 7 as the folded tap product (csrc/l7.cu, the bf16 stacks' last
layer) on the CPU: its weights (ops/s2d.py:pack_l7_fold, StackParams.w7f)
against the JAX package's, its plain version (stack.l7_fold_plain) against
the JAX kernel in interpret mode and against the per-pixel layer's plain
version, its three output forms, which C entry each call reaches (a fake
library stands in for the card); the library yardstick of the probe maps
that copy one block; and a seedless probe store, which runs on the CPU only
when asked.

Bars: f32 within 3e-5 (the JAX kernel suite's); the fold against the
per-pixel sum within 1e-5 on f32 values (two summation orders of the same
products); bf16 max |diff| <= 2^-4 against the JAX kernel and >= 50 dB
against f32; u8 equal except |diff| <= 1 at < 0.2% of bytes, where the two
sides take their f32 sums in another order before the final rounding. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (phase 21)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_tpu.ops import s2d as js2d
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import probe, s2d, stack

torch.set_num_threads(2)

TILE = (16, 16)
GUARD = [(1, 27, 38), (2, 37, 53), (1, 5, 300)]
JAX_SHAPES = [(2, 16, 16), (1, 13, 22)]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def sp16(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")


def _x6(shape, seed, dtype=torch.float32):
    """A random layer-6 plane [N, 2hl+2, 2wl+2, 128] for the cells (N, hl,
    wl), drawn with numpy."""
    n, hl, wl = shape
    x = np.random.default_rng(seed).random((n, 2 * hl + 2, 2 * wl + 2, 128),
                                           dtype=np.float32)
    return torch.from_numpy(x).to(dtype)


def _fold_f32(ylow: torch.Tensor, sp) -> torch.Tensor:
    """The f32 stack with its last layer folded: layers 1-5 whole
    (stack_scale_upto, out="whole"), layer 6 from the packed weights, then
    l7_fold_plain -> f32 Y [N, hl, wl, 4]."""
    x5 = stack.stack_scale_upto(ylow, sp, 5, out="whole")
    x6 = stack.mma_layer_plain(x5, sp.wm[4], sp[5][1])
    return stack.l7_fold_plain(x6, sp.w7f, sp[6][1])


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return 10 * np.log10(1.0 / mse)


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


# --- the weights -------------------------------------------------------------

def test_pack_l7_fold_matches_jax(rng):
    """The port's own copy of pack_l7_fold equals the JAX package's, and
    each entry is one weight or zero (no tap is summed twice)."""
    w7 = rng.standard_normal((3, 3, 128, 1)).astype(np.float32)
    got = s2d.pack_l7_fold(w7)
    np.testing.assert_array_equal(got, js2d.pack_l7_fold(w7))
    assert got.shape == (512, 16) and got.dtype == np.float32
    assert set(np.unique(got)) <= set(np.unique(w7)) | {0.0}
    assert np.count_nonzero(got) == 4 * 9 * 128   # each (phase, tap) once
    with pytest.raises(ValueError, match="3, 3, ci, 1"):
        s2d.pack_l7_fold(w7[:, :, :, :1].repeat(2, axis=3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prep_params_carries_w7f(params_np, dtype):
    sp = stack.prep_params(params_from_numpy(params_np), dtype, "cpu")
    want = torch.from_numpy(s2d.pack_l7_fold(params_np[6]["w"])).to(dtype)
    assert sp.w7f.shape == (512, 16) and sp.w7f.dtype == dtype
    assert sp.w7f.is_contiguous() and torch.equal(sp.w7f, want)


# --- the plain version -------------------------------------------------------

@pytest.mark.parametrize("shape", GUARD, ids=[str(s) for s in GUARD])
def test_fold_plain_matches_per_pixel_plain(sp32, shape):
    """On f32 values the fold and the per-pixel layer (last_layer_plain's
    sum before its rounding) are two orders of the same products: within
    1e-5 at the guard shapes."""
    x6 = _x6(shape, sum(shape))
    got = stack.l7_fold_plain(x6, sp32.w7f, sp32[6][1])
    ref = stack._last_layer_f32(x6, *sp32[6])
    assert got.shape == ref.shape == (shape[0], shape[1], shape[2], 4)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(stack.last_layer_plain(x6, *sp32[6]), ref)


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=[str(s) for s in JAX_SHAPES])
def test_fold_f32_matches_pallas_interpret(params_np, sp32, rng, shape):
    """The f32 stack ending in the fold against the JAX kernel (l7_fold on
    by default) in interpret mode, s2d and dense forms (each dense form
    un-chunked): within 3e-5."""
    ylow = rng.random(shape, dtype=np.float32)
    n, hl, wl = shape
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jps.stack_scale(jnp.asarray(ylow), kp, spec, tile=TILE,
                                     interpret=True))
    y = _fold_f32(torch.from_numpy(ylow), sp32)
    np.testing.assert_allclose(stack.last_out(y, "s2d", torch.float32),
                               ref, rtol=0, atol=3e-5)
    jdense, jtc = jps.stack_scale_dense(jnp.asarray(ylow), kp, spec, TILE,
                                        interpret=True)
    # the port's chunk is a multiple of 32 columns, JAX's its tile's: held
    # un-chunked
    ydense, tc = stack.last_out(y, "dense", torch.float32)
    np.testing.assert_allclose(
        stack.dense_to_s2d(ydense, tc, hl, wl).numpy(),
        np.asarray(jps.dense_to_s2d(jdense, jtc, hl, wl)), rtol=0, atol=3e-5)


@pytest.mark.parametrize("shape", [(2, 18, 20), (1, 13, 22)])
def test_fold_u8_matches_pallas_interpret(params_np, sp32, rng, monkeypatch,
                                          shape):
    """The fold's u8 form on the f32 stack against the JAX kernel's fused
    u8 epilogue (f32 U/V phases): |diff| <= 1 at under 0.2% of bytes,
    lanes 12:16 zero."""
    n, h, w = shape
    yuv = rng.random((n, h, w, 3), dtype=np.float32)
    monkeypatch.setattr(jps, "UVP_MODE", "f32")
    kp, spec = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jps.stack_scale_fused_u8(
        jnp.asarray(yuv[..., 0]), jpl._uv_phases_cmajor(jnp.asarray(yuv),
                                                        TILE),
        kp, spec, TILE, interpret=True))
    t = torch.from_numpy(yuv)
    y = _fold_f32(t[..., 0].contiguous(), sp32)
    got = stack.last_out(y, "u8", torch.float32, pl._uv_phases_cmajor(t))
    assert got.shape == (n, h, w, 16) and not got[..., 12:].any()
    _assert_u8_close(got.numpy(), ref)


def test_bf16_stack_matches_pallas_interpret(params_np, sp16, sp32, rng):
    """The bf16 stack on the CPU (plain, layer 7 folded) against the JAX
    kernel with bf16 weights in interpret mode: max |diff| <= 2^-4, both
    >= 50 dB against the f32 stack."""
    ylow = rng.random((2, 13, 22), dtype=np.float32)
    y16 = torch.from_numpy(ylow).to(torch.bfloat16)
    got = stack.stack_scale(y16, sp16).float()
    kp, spec = jps.prep_params(params_np, scale_input=True,
                               dtype=jnp.bfloat16)
    ref = torch.from_numpy(np.asarray(jps.stack_scale(
        jnp.asarray(y16.float().numpy(), jnp.bfloat16), kp, spec, tile=TILE,
        interpret=True), np.float32))
    y32 = stack.stack_scale(torch.from_numpy(ylow), sp32)
    assert got.shape == ref.shape == y32.shape
    assert (got - ref).abs().max().item() <= 2.0 ** -4
    assert _psnr(got, y32) >= 50.0 and _psnr(ref, y32) >= 50.0


def test_bf16_stacks_end_in_the_fold(sp16, rng):
    """Every bf16 plain stack's last layer is l7_fold_plain on its layer-6
    plane, rounded once: stack_scale equals the fold of the bf16 layers
    1-6 bit for bit."""
    y = torch.from_numpy(rng.random((1, 9, 11), dtype=np.float32)).to(
        torch.bfloat16)
    x5 = stack.stack_scale_upto(y, sp16, 5, out="whole")
    x6 = stack._plain_layer(x5.float().permute(0, 3, 1, 2), *sp16[5],
                            torch.bfloat16).permute(0, 2, 3, 1)
    fold = stack.l7_fold_plain(x6, sp16.w7f, sp16[6][1])
    assert torch.equal(stack.stack_scale_plain(y, sp16),
                       fold.to(torch.bfloat16))
    x6 = x6.to(torch.bfloat16).contiguous()
    assert torch.equal(stack.last_layer(x6, sp16), fold.to(torch.bfloat16))


# --- the output forms --------------------------------------------------------

@pytest.mark.parametrize("shape,tc", [((1, 5, 70), None), ((1, 5, 70), 32),
                                      ((2, 7, 9), None)])
def test_dense_unchunked_equals_s2d(sp16, shape, tc):
    """The dense form un-chunked (dense_to_s2d) is the s2d form bit for bit,
    and the last chunk's pad columns read zero."""
    n, hl, wl = shape
    x6 = _x6(shape, 3, torch.bfloat16)
    ydense, tc_out = stack.last_layer(x6, sp16, out="dense", tc=tc)
    assert tc_out % 32 == 0 and (tc is None or tc_out == tc)
    nx = -(-wl // tc_out)
    assert ydense.shape == (n, hl, nx * 4 * tc_out)
    want = stack.last_layer(x6, sp16)
    assert torch.equal(stack.dense_to_s2d(ydense, tc_out, hl, wl), want)
    chunks = ydense.reshape(n, hl, nx, 4, tc_out)
    assert not chunks[:, :, -1, :, wl - (nx - 1) * tc_out:].any()


def test_u8_form_is_the_colour_map_of_the_f32_y(sp16):
    """The u8 form maps the fold's f32 Y (never rounded to bf16) with
    combine_u8_cmajor, lanes 12:16 zero."""
    x6 = _x6((2, 6, 7), 5, torch.bfloat16)
    uvp = torch.from_numpy(np.random.default_rng(6).random(
        (2, 6, 7, 8), dtype=np.float32))
    got = stack.last_layer(x6, sp16, out="u8", uvp=uvp)
    y = stack.l7_fold_plain(x6, sp16.w7f, sp16[6][1])
    assert not torch.equal(y, y.to(torch.bfloat16).float())
    chans = stack.combine_u8_cmajor(y, uvp[..., 0:4], uvp[..., 4:8])
    assert got.dtype == torch.uint8 and got.shape == (2, 6, 7, 16)
    assert torch.equal(got[..., :12], torch.cat(chans, dim=-1))
    assert not got[..., 12:].any()


@pytest.mark.parametrize("zs", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_masked_fold_is_the_per_pixel_function(dtype, zs):
    """l7_fold_plain under each zero-shift mask against last_layer_plain
    under the same mask (the per-pixel 9-tap sum with r(p, k) on a zeroed
    axis), bit for bit on exact inputs: x6 and w7 in sixteenths, the bias
    in 256ths, so every f32 sum is exact in either order; the masks give
    four different functions."""
    rng = np.random.default_rng(30 + zs)
    x6 = torch.from_numpy(rng.integers(0, 16, (2, 12, 16, 128)) / 16).to(
        dtype)
    w7 = torch.from_numpy((rng.integers(0, 16, (128, 9, 1)) - 8) / 16).to(
        torch.float32)
    b7 = torch.tensor([-37 / 256], dtype=torch.float32)
    w7f = torch.from_numpy(s2d.pack_l7_fold(
        w7.permute(1, 0, 2).reshape(3, 3, 128, 1).numpy())).to(dtype)
    fold = stack.l7_fold_plain(x6, w7f, b7, zs)
    per_pixel = stack._last_layer_f32(x6, w7.to(dtype), b7, zs)
    assert fold.shape == (2, 5, 7, 4) and fold.dtype == torch.float32
    assert torch.equal(fold, per_pixel)
    assert torch.equal(fold.to(dtype),
                       stack.last_layer_plain(x6, w7.to(dtype), b7, zs))
    others = [stack.l7_fold_plain(x6, w7f, b7, z) for z in range(4) if z != zs]
    assert all(not torch.equal(fold, o) for o in others)


def test_fold_false_is_the_ffma_kernels_plain_version(sp16):
    """last_layer(fold=False) is the FFMA kernels' function: the per-pixel
    sum for s2d, the same f32 Y through last_out for dense and u8."""
    x6 = _x6((1, 4, 6), 8, torch.bfloat16)
    uvp = torch.rand((1, 4, 6, 8), generator=torch.Generator().manual_seed(1))
    y = stack._last_layer_f32(x6, *sp16[6])
    assert torch.equal(stack.last_layer(x6, sp16, fold=False),
                       stack.last_layer_plain(x6, *sp16[6]))
    assert torch.equal(stack.last_layer(x6, sp16, out="dense",
                                        fold=False)[0],
                       stack.last_out(y, "dense", torch.bfloat16)[0])
    assert torch.equal(stack.last_layer(x6, sp16, out="u8", uvp=uvp,
                                        fold=False),
                       stack.last_out(y, "u8", torch.bfloat16, uvp))


def test_last_layer_refuses_what_it_does_not_take(sp16, sp32):
    x6 = _x6((1, 3, 4), 9, torch.bfloat16)
    with pytest.raises(ValueError, match="zs"):
        stack.last_layer(x6, sp16, zs=1, out="dense")
    with pytest.raises(ValueError, match="out must be"):
        stack.last_layer(x6, sp16, out="planar")
    with pytest.raises(ValueError, match="uvp"):
        stack.last_layer(x6, sp16, out="u8")
    with pytest.raises(ValueError, match="zs"):
        stack.last_layer(x6.float(), sp32, zs=1, out="u8",
                         uvp=torch.zeros((1, 3, 4, 8)))
    with pytest.raises(ValueError, match="zs"):
        stack.last_layer(x6, sp16, zs=4)
    with pytest.raises(ValueError, match="w7f"):
        stack.last_layer(x6, stack.StackParams(list(sp16)))
    with pytest.raises(ValueError, match="w7f"):
        stack.stack_scale(torch.rand(1, 3, 4).to(torch.bfloat16),
                          stack.StackParams(list(sp16)))


# --- the dispatch ------------------------------------------------------------

def test_fold_is_chosen_for_bf16_without_a_mask():
    """The fold is the default on every plane, with or without a zero-shift
    mask, in both storage types (the choice reads no dtype); fold=False asks
    for the FFMA kernels, under a mask too."""
    assert stack.l7_fold_chosen()
    assert stack.l7_fold_chosen(zs=3)
    assert not stack.l7_fold_chosen(fold=False)
    assert not stack.l7_fold_chosen(zs=2, fold=False)
    assert stack.l7_fold_chosen(zs=1, fold=True)
    with pytest.raises(ValueError, match="zs"):
        stack.l7_fold_chosen(zs=4)


class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.mark.parametrize("dtype,out_mode,fold,entry,kernel", [
    (torch.bfloat16, 0, None, "w2x_l7_fold", "fold"),
    (torch.bfloat16, 1, None, "w2x_l7_fold", "fold"),
    (torch.bfloat16, 2, None, "w2x_l7_fold", "fold"),
    (torch.bfloat16, 0, False, "w2x_stack_layer", "pixel"),
    (torch.bfloat16, 2, False, "w2x_stack_layer", "cell"),
    (torch.float32, 0, None, "w2x_l7_fold", "fold_f32"),
    (torch.float32, 1, None, "w2x_l7_fold", "fold_f32"),
    (torch.float32, 2, None, "w2x_l7_fold", "fold_f32"),
    (torch.float32, 0, False, "w2x_stack_layer", "pixel"),
    (torch.float32, 1, False, "w2x_stack_layer", "cell")])
def test_layer7_dispatch(sp16, sp32, dtype, out_mode, fold, entry, kernel):
    """Layer 7 of a stack reaches the fold in both storage types (in every
    output form) unless fold=False, which takes the FFMA kernels; each
    launch counts once under L7_LAUNCHES by kernel, and the fold's entry
    gets the weights of its type (bf16 w7f, f32 w7's taps), the cells of
    the plane and the form."""
    stack.reset_launches()
    sp = sp16 if dtype == torch.bfloat16 else sp32
    calls = []
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "scale", None, 0
    run.libs = {name: _FakeLib(calls) for name in ("stack", "l6", "l7")}
    run.bf16, run.stream = int(dtype == torch.bfloat16), 0
    x = torch.zeros(1, dtype=dtype)
    run.layer(6, False, x, sp, x, 3, 20, 36, out_mode, None, None, 32,
              fold=fold)
    assert [fn for fn, _ in calls] == [entry]
    assert stack.L7_LAUNCHES == {k: int(k == kernel) for k in
                                 ("fold", "fold_f32", "cell", "pixel")}
    assert stack.LAUNCHES == stack.KERNEL_LAUNCHES["scale"] == 1
    args = calls[0][1]
    if kernel.startswith("fold"):
        # (bf16, x6, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
        #  tr, tc, ny, nx, zs, stream): one plane an image, no tiling, no
        #  mask
        bf16 = dtype == torch.bfloat16
        assert args[0] == int(bf16)
        assert args[2] == (sp.w7f if bf16 else sp[6][0]).data_ptr()
        assert args[3] == sp[6][1].data_ptr()
        assert args[5:9] == (3, 20, 36, out_mode)
        assert args[11:] == (32, 0, 0, 0, 0, 0, 0)
    stack.reset_launches()
    assert stack.L7_LAUNCHES == {"fold": 0, "fold_f32": 0, "cell": 0,
                                 "pixel": 0}


def test_noise_stack_layer7_gets_the_even_cells(sp16):
    """The noise stack's layer 7 runs on the plane rounded up to even: the
    fold gets its cells."""
    calls = []
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "noise", None, 0
    run.libs = {"l7": _FakeLib(calls)}
    run.bf16, run.stream = 1, 0
    x = torch.zeros(1, dtype=torch.bfloat16)
    run.layer(6, True, x, sp16, x, 1, 27, 38)
    assert calls[0][0] == "w2x_l7_fold" and calls[0][1][5:8] == (1, 14, 19)
    stack.reset_launches()


def test_cpu_calls_launch_nothing(sp16, rng):
    """No layer-7 launch is counted on the CPU, by any wrapper."""
    stack.reset_launches()
    y = torch.from_numpy(rng.random((1, 6, 7), dtype=np.float32)).to(
        torch.bfloat16)
    uvp = torch.rand((1, 6, 7, 8))
    stack.stack_scale(y, sp16)
    stack.stack_scale_dense(y, sp16)
    stack.stack_scale_fused_u8(y, uvp, sp16)
    stack.stack_noise(y, sp16)
    stack.last_layer(_x6((1, 2, 3), 1, torch.bfloat16), sp16)
    assert stack.L7_LAUNCHES == {"fold": 0, "fold_f32": 0, "cell": 0,
                                 "pixel": 0}
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())


def test_shift_probe_keeps_one_layer7_kernel_across_modes(sp16, rng):
    """shift_stack runs layer 7 folded in every mode (the JAX tool's
    structure), under each mode's mask, so its modes differ in the masks
    alone and base is stack_scale's function; stack_scale_pp ends in the
    fold, equal to stack_scale's plain version with the packed weights."""
    y = torch.from_numpy(rng.random((1, 8, 10), dtype=np.float32)).to(
        torch.bfloat16)
    x6 = probe._variant_layers_plain(y, sp16, 6, (0,) * 7)[-1]
    assert torch.equal(probe.shift_stack(y, sp16, 1, 1),
                       stack.l7_fold_plain(x6, sp16.w7f, sp16[6][1])
                       .to(torch.bfloat16))
    for mode, (fx, fy) in probe.SHIFT_MODES.items():
        zs = probe.shift_zs(fx, fy)
        x6z = probe._variant_layers_plain(y, sp16, 6, (0,) + (zs,) * 6)[-1]
        assert torch.equal(probe.shift_stack(y, sp16, fx, fy),
                           stack.l7_fold_plain(x6z, sp16.w7f, sp16[6][1], zs)
                           .to(torch.bfloat16)), mode
    fold = stack.l7_fold_plain(x6, sp16.w7f, sp16[6][1])
    assert torch.equal(probe.stack_scale_pp(y, sp16),
                       fold.to(torch.bfloat16))


# --- probe_fetch_map's yardstick and the seedless store ----------------------

G = probe.Grid(1, 2, 2, 16, 32)


@pytest.mark.parametrize("name", [n for n, v in probe.VARIANTS.items()
                                  if probe.library_is_the_map(v)])
def test_library_is_the_copy_maps_function(name):
    """For each map that copies one block, the library yardstick's output
    is the map's own output byte for byte (so the ratio compares one
    function); the five are the variants the card's rebuilt copies serve."""
    v = probe.VARIANTS[name]
    args = probe.make_inputs(v, G, 0, "cpu")
    ref = probe.plain(v, G, args)
    lib = probe.library(v, G, args, "cpu")()
    assert lib.numel() == ref.numel() and lib.dtype == ref.dtype
    assert torch.equal(lib.reshape(ref.shape), ref)


def test_copy_maps_are_the_five():
    assert sorted(n for n, v in probe.VARIANTS.items()
                  if probe.library_is_the_map(v)) == [
        "1-fetch", "lane16_x1", "oneblk", "raw2d", "y512n"]


def test_seedless_store_runs_on_the_cpu_only_when_asked(monkeypatch):
    """A store with no seed has no tensor to name a device: run and plain
    resolve None to the card and raise where there is none; device="cpu"
    runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = probe.VARIANTS["out4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run(v, G, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.plain(v, G, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.store_plain(v, G)
    out = probe.run(v, G, {}, device="cpu")
    assert out.device.type == "cpu"
    assert torch.equal(out, probe.plain(v, G, {}, "cpu"))
    seeded = probe.VARIANTS["c4"]
    assert probe.run(seeded, G, probe.make_inputs(seeded, G, 0, "cpu")
                     ).device.type == "cpu"
