"""Layer 1 of the conv stack (csrc/l1.cu) on the CPU: the scale stack's
phase-summed weights (ops/s2d.py:pack_l1_scale, StackParams.w1s) against
the JAX package's packer, the port's scale stack against the JAX kernel in
interpret mode on the shipped scale2.0x weights, the plain version
(stack.l1_plain) against loops over the clamped positions and against the
FFMA plane modes' function, and which C entry each call reaches (a fake
library stands in for the card).

Bars: the bf16 scale stack agrees with the JAX kernel at >= 60 dB and within
2^-4, its PSNR against the port's f32 stack at most 0.1 dB under the JAX
kernel's; f32 within 3e-5 (the JAX kernel suite's bar); the plain layer
equal bit for bit to the loops that take its products in its order. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py (phase 23)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.models.weights import load_model_json as jax_load_model
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_tpu.ops import s2d as js2d
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TILE = (16, 16)


@pytest.fixture(scope="module")
def shipped():
    """The shipped scale2.0x weights as the JAX package loads them, and the
    port's StackParams of them in f32 and bf16."""
    pj = as_numpy(jax_load_model(ROOT / "models" / "scale2.0x_demo.json"))
    pt = params_from_numpy(pj)
    return (pj, stack.prep_params(pt, torch.float32, "cpu"),
            stack.prep_params(pt, torch.bfloat16, "cpu"))


@pytest.fixture(scope="module")
def rand_params():
    import jax
    return as_numpy(init_params(jax.random.PRNGKey(5), JFLAGSHIP))


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(1.0 / mse)


def _planes(rng, shape):
    """A pure-random plane (every pixel an edge) and an image-like one."""
    n, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
             + 0.02 * rng.standard_normal((n, h, w))).astype(np.float32)
    return {"random": rng.random(shape, dtype=np.float32), "image": image}


# --- the packer --------------------------------------------------------------

def test_pack_l1_scale_matches_jax(shipped, rand_params):
    for p in (shipped[0], rand_params):
        w1 = p[0]["w"]
        got, ref = s2d.pack_l1_scale(w1), js2d.pack_l1_scale(w1)
        assert got.dtype == np.float32 and got.shape == (9, 128)
        assert np.array_equal(got, ref)
        assert np.array_equal(s2d.pack_w2(w1), js2d.pack_w2(w1))


def test_pack_l1_scale_phase_structure(rand_params):
    """Phase (A, B) has non-zero weights in rows dy' in {A, A+1}, dx' in
    {B, B+1} only, each the sum of the 3 x 3 taps landing on that low-res
    pixel of the nearest-2x upscale."""
    w1 = rand_params[0]["w"]
    eff = s2d.pack_l1_scale(w1).reshape(3, 3, 2, 2, 32)
    groups = ({0: (0,), 1: (1, 2)}, {0: (0, 1), 1: (2,)})   # [A][r] -> taps
    for a in range(2):
        for b in range(2):
            for dy in range(3):
                for dx in range(3):
                    r, s = dy - a, dx - b
                    if r not in (0, 1) or s not in (0, 1):
                        assert not eff[dy, dx, a, b].any()
                        continue
                    want = sum(w1[ty, tx, 0] for ty in groups[a][r]
                               for tx in groups[b][s])
                    np.testing.assert_allclose(eff[dy, dx, a, b], want,
                                               rtol=1e-6, atol=1e-7)


def test_prep_params_rounds_the_sums_once(shipped):
    pj, sp32, sp16 = shipped
    eff = torch.from_numpy(s2d.pack_l1_scale(pj[0]["w"]))
    assert torch.equal(sp32.w1s, eff)
    assert sp16.w1s.dtype == torch.bfloat16
    assert torch.equal(sp16.w1s, eff.to(torch.bfloat16))
    # the sums of the per-tap bf16 weights round differently somewhere
    taps = sp16[0][0].float().reshape(1, 3, 3, 32).permute(1, 2, 0, 3)
    merged = torch.from_numpy(s2d.pack_l1_scale(taps.numpy()))
    assert not torch.equal(merged.to(torch.bfloat16), sp16.w1s)


def test_bare_tuple_forms_the_sums_from_its_weights(shipped):
    """Weights without StackParams.w1s (a bare tuple) still run: their sums
    come from the stored layer-1 weights, which in f32 are prep_params'."""
    _, sp32, _ = shipped
    y = torch.from_numpy(np.random.default_rng(1).random((1, 6, 7),
                                                         dtype=np.float32))
    assert torch.equal(stack.l1_plain(y, tuple(sp32)), stack.l1_plain(y, sp32))


# --- C7: the scale stack against the JAX kernel ------------------------------

@pytest.mark.parametrize("kind", ["random", "image"])
def test_bf16_scale_stack_matches_jax_kernel(shipped, kind):
    """The port's bf16 scale stack (plain, on the CPU) against the JAX kernel
    with bf16 weights in interpret mode, shipped weights: >= 60 dB apart and
    within 2^-4; against the port's f32 stack no more than 0.1 dB under the
    JAX kernel."""
    pj, sp32, sp16 = shipped
    ylow = _planes(np.random.default_rng(11), (1, 32, 48))[kind]
    y16 = torch.from_numpy(ylow).to(torch.bfloat16)
    kp, spec = jps.prep_params(pj, scale_input=True, dtype=jnp.bfloat16)
    ref = np.asarray(jps.stack_scale(
        jnp.asarray(y16.float().numpy(), jnp.bfloat16), kp, spec, tile=TILE,
        interpret=True), np.float32)
    got = stack.stack_scale(y16, sp16).float().numpy()
    y32 = stack.stack_scale(torch.from_numpy(ylow), sp32).numpy()
    assert got.shape == ref.shape == y32.shape
    assert np.abs(got - ref).max() <= 2.0 ** -4
    assert _psnr(got, ref) >= 60.0
    assert _psnr(got, y32) >= _psnr(ref, y32) - 0.1


def test_f32_scale_stack_matches_jax_kernel(shipped):
    pj, sp32, _ = shipped
    ylow = _planes(np.random.default_rng(12), (2, 16, 20))["random"]
    kp, spec = jps.prep_params(pj, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jps.stack_scale(jnp.asarray(ylow), kp, spec, tile=TILE,
                                     interpret=True))
    got = stack.stack_scale(torch.from_numpy(ylow), sp32).numpy()
    assert np.abs(got - ref).max() <= 3e-5


# --- the plain version -------------------------------------------------------

def _l1_scale_loops(ylow: np.ndarray, sp) -> torch.Tensor:
    """Layer 1 of the scale stack by loops over every output pixel: the four
    positions of pad4(ylow) its phase reads, each through its own clamp, times
    the stored phase sums, added in f32 to the bias in (r, s) order."""
    n, hl, wl = ylow.shape
    w = sp.w1s.float().numpy()
    b = sp[0][1].numpy()
    out = np.zeros((n, 2 * hl + 12, 2 * wl + 12, 32), np.float32)
    for y in range(2 * hl + 12):
        for x in range(2 * wl + 12):
            k, j, a, bb = y >> 1, x >> 1, y & 1, x & 1
            acc = np.broadcast_to(b, (n, 32)).astype(np.float32)
            for r in range(2):
                for s in range(2):
                    p = min(max(k + a + r - 4, 0), hl - 1)
                    q = min(max(j + bb + s - 4, 0), wl - 1)
                    t, lanes = (a + r) * 3 + bb + s, (a * 2 + bb) * 32
                    acc = acc + ylow[:, p, q, None] * w[t, lanes:lanes + 32]
            out[:, y, x] = acc
    v = torch.from_numpy(out)
    return torch.clamp(v, min=0) + 0.1 * torch.clamp(v, max=0)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 2), (2, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l1_plain_scale_matches_loops(shipped, shape, dtype):
    """Bit for bit, at planes so small that the clamped positions of a
    pixel's four taps coincide: each keeps its own phase sum."""
    _, sp32, sp16 = shipped
    sp = sp32 if dtype == torch.float32 else sp16
    y = torch.from_numpy(np.random.default_rng(2).random(
        shape, dtype=np.float32)).to(dtype)
    ref = _l1_scale_loops(y.float().numpy(), sp).to(dtype)
    got = stack.l1_plain(y, sp)
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 6, 9)])
def test_l1_plain_noise_is_the_ffma_function(shipped, shape):
    """The noise layer 1: the 9 taps on the plane padded to even and by 7,
    the function of stack.cu's plane mode (F.conv2d) to f32 rounding."""
    _, sp32, _ = shipped
    y = torch.from_numpy(np.random.default_rng(3).random(
        shape, dtype=np.float32))
    got = stack.l1_plain(y, sp32, full_res=True)
    ref = stack.l1_plain(y, sp32, full_res=True, ffma=True)
    n, h, w = shape
    assert got.shape == (n, 2 * -(-h // 2) + 12, 2 * -(-w // 2) + 12, 32)
    assert (got - ref).abs().max().item() <= 1e-6


def test_l1_plain_scale_is_the_per_tap_function_in_f32(shipped):
    """In f32 the phase sums and the per-tap weights on the nearest-2x
    upscale are one function, to f32 rounding."""
    _, sp32, _ = shipped
    y = torch.from_numpy(np.random.default_rng(4).random((2, 7, 9),
                                                         dtype=np.float32))
    got = stack.l1_plain(y, sp32)
    ref = stack.l1_plain(y, sp32, ffma=True)
    assert got.shape == ref.shape == (2, 26, 30, 32)
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_layer1_is_l1_plain(shipped, dtype):
    """What every plain scale stack feeds layer 2 (stack_scale_upto's whole
    layer-1 plane) is l1_plain's output bit for bit."""
    _, sp32, sp16 = shipped
    sp = sp32 if dtype == torch.float32 else sp16
    y = torch.from_numpy(np.random.default_rng(5).random(
        (1, 9, 11), dtype=np.float32)).to(dtype)
    assert torch.equal(stack.stack_scale_upto(y, sp, 1, out="whole"),
                       stack.l1_plain(y, sp))


def test_l1_layer_on_cpu_is_the_plain_version(shipped):
    _, sp32, sp16 = shipped
    y = torch.from_numpy(np.random.default_rng(6).random((1, 5, 6),
                                                         dtype=np.float32))
    stack.reset_launches()
    for sp, x in ((sp32, y), (sp16, y.to(torch.bfloat16))):
        for full_res in (False, True):
            for ffma in (False, True):
                assert torch.equal(stack.l1_layer(x, sp, full_res, ffma),
                                   stack.l1_plain(x, sp, full_res, ffma))
    assert stack.LAUNCHES == 0 and not any(stack.L1_LAUNCHES.values())


# --- the dispatch ------------------------------------------------------------

class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def _fake_launcher(calls, bf16: bool, kind="scale"):
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = kind, None, 0
    run.libs = {name: _FakeLib(calls)
                for name in ("stack", "mma", "l6", "l7", "l1", "mma_tf32")}
    run.bf16, run.stream = int(bf16), 0
    return run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full_res", [False, True])
def test_layer1_dispatch(shipped, dtype, full_res):
    """Layer 1 of a stack reaches w2x_l1 with the phase sums (scale) or w1
    (noise), counted once under L1_LAUNCHES["l1"] and once as a stack
    launch; l1(ffma=True) reaches stack.cu's layer 0 and counts "ffma"."""
    _, sp32, sp16 = shipped
    sp = sp32 if dtype == torch.float32 else sp16
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls, dtype == torch.bfloat16,
                         "noise" if full_res else "scale")
    x = torch.zeros(1, dtype=dtype)
    run.layer(0, full_res, x, sp, x, 3, 11, 14)
    assert [fn for fn, _ in calls] == ["w2x_l1"]
    # (bf16, full_res, x, w, b, y, n, ph, pw, stream)
    args = calls[0][1]
    assert args[:2] == (int(dtype == torch.bfloat16), int(full_res))
    w = sp[0][0] if full_res else sp.w1s
    assert args[3] == w.data_ptr() and args[4] == sp[0][1].data_ptr()
    assert args[6:] == (3, 11, 14, 0)
    assert stack.L1_LAUNCHES == {"l1": 1, "ffma": 0}
    assert stack.LAUNCHES == 1 and not any(stack.MID_LAUNCHES.values())
    run.kind = None
    run.l1(full_res, x, sp, x, 3, 11, 14, ffma=True)
    fn, args = calls[1]
    assert fn == "w2x_stack_layer" and args[1:3] == (int(full_res), 0)
    assert stack.L1_LAUNCHES == {"l1": 1, "ffma": 1} and stack.LAUNCHES == 1
    stack.reset_launches()


def test_layer1_has_no_variant(shipped):
    _, _, sp16 = shipped
    calls = []
    run = _fake_launcher(calls, True)
    x = torch.zeros(1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no variant"):
        run.layer(0, False, x, sp16, x, 1, 10, 12, zs=1)
    assert not calls
