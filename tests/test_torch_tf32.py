"""The f32 stacks' layers 2-6 as 3xTF32 split products (csrc/mma_tf32.cu)
on the CPU: the split of the weights (ops/s2d.py:tf32_round,
pack_mma_tf32, StackParams.wt), a plain emulation of the kernel's
arithmetic over whole stacks of the shipped models, the shared-memory plan
(stack.tf32_plan) against the kernel's table, and which C entry each f32
call reaches (a fake library stands in for the card).

The emulation takes each product a*w of layers 2-6 as a_lo*w_hi + a_hi*w_lo
+ a_hi*w_hi, with w_hi = rna(w), w_lo = rna(w - w_hi) as packed and the
activation split as the kernel splits it, a_hi = rna(a), a_lo =
rna(a - a_hi), each operand then cut to TF32 as wgmma reads an f32 value
(its low 13 mantissa bits dropped: a no-op on these), the products summed
in f64. "split_raw" is the split that leaves a_hi to that cut (a_hi = the
raw window, a_lo = a - trunc(a), both truncated). It is a test of the
scheme and lives here: no product path runs it. Bars: both splits within
3e-5 of the f32 plain stack (the JAX kernel suite's f32 bar), one TF32
product (the tensor cores on f32 operands) not; hi + lo within 2^-21 of w,
relative. The CUDA kernel itself is held against the f32 plain version on
the card by chip_smoke.py (phase 22)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.models.weights import load_model_json
from waifu2x_torch.ops import s2d, stack
from waifu2x_torch.ops.convstack import leaky_relu

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 3e-5


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its low 13 mantissa bits dropped: an f32 operand as wgmma
    reads it as TF32."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


@pytest.fixture(scope="module")
def sp32():
    return stack.prep_params(init_params(3), torch.float32, "cpu")


@pytest.fixture(scope="module")
def sp16():
    return stack.prep_params(init_params(3), torch.bfloat16, "cpu")


# --- the split ---------------------------------------------------------------

def test_tf32_round_and_trunc():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -10 - 2.0 ** -23,
                      0.0, 3.0e-39])
    r, t = s2d.tf32_round(x), tf32_trunc(x)
    for v in (r, t):
        assert not (v.view(torch.int32) & 0x1FFF).any()
    # a tie rounds away from zero, as cvt.rna does
    assert r[1].item() == 1.0 + 2.0 ** -10 and r[3].item() == -r[1].item()
    assert r[2].item() == 1.0 + 2.0 ** -10 and r[0].item() == 1.0
    assert t[1].item() == 1.0 and t[4].item() == 1.0 and t[3].item() == -1.0
    assert r[5].item() == t[5].item() == 0.0


def test_pack_mma_tf32_round_trips(rng):
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 32)).astype(
        np.float32))
    hi, lo = s2d.pack_mma_tf32(w)
    assert hi.shape == lo.shape == (16, 9, 32, 4)
    assert hi.dtype == lo.dtype == torch.float32 and hi.is_contiguous()
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    taps = w.reshape(9, 64, 32)
    assert torch.equal(s2d.unpack_mma(hi), s2d.tf32_round(taps))
    back = s2d.unpack_mma(hi) + s2d.unpack_mma(lo)
    assert ((back - taps).abs() <= 2.0 ** -21 * taps.abs()).all()
    # out[c4, t, o, k] = w[t // 3, t % 3, 4*c4 + k, o]
    assert hi[3, 5, 7, 2].item() == s2d.tf32_round(w[1, 2, 14, 7]).item()
    with pytest.raises(ValueError, match="multiple of 4"):
        s2d.pack_mma_tf32(torch.zeros(3, 3, 6, 8))


def test_prep_params_splits_f32_weights_only(sp32, sp16):
    assert sp16.wt is None
    assert len(sp32.wt) == 5
    params = init_params(3)
    for (hi, lo), p, (ci, co) in zip(sp32.wt, params[1:6],
                                     stack.WIDTHS[1:6]):
        want = s2d.pack_mma_tf32(p["w"])
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
        assert hi.shape == (ci // 4, 9, co, 4)


# --- the emulation -----------------------------------------------------------

def _emulated_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """One 3x3 layer + bias + LeakyReLU on f32 values [N, ci, H, W], its
    products as the tensor cores would take them: "split" the kernel's three
    TF32 terms, "split_raw" the same with the activation's halves cut by
    truncation, "tf32" one TF32 product of the truncated operands; every
    operand cut as wgmma reads it (tf32_trunc), sums in f64, rounded to f32
    once."""
    ci, _, co = w.shape
    w = w.float().reshape(ci, 3, 3, co).permute(3, 0, 1, 2)
    cut = tf32_trunc
    if mode == "tf32":
        y = F.conv2d(cut(x).double(), cut(w).double())
    else:
        a_hi = s2d.tf32_round(x) if mode == "split" else cut(x)
        a_lo = x - a_hi
        if mode == "split":
            a_lo = s2d.tf32_round(a_lo)
        w_hi = s2d.tf32_round(w)
        w_lo = s2d.tf32_round(w - w_hi)
        a_hi, a_lo, w_hi, w_lo = (cut(t).double()
                                  for t in (a_hi, a_lo, w_hi, w_lo))
        y = (F.conv2d(a_lo, w_hi) + F.conv2d(a_hi, w_lo)
             + F.conv2d(a_hi, w_hi))
    return leaky_relu(y.float() + b[:, None, None])


def _stack(plane: torch.Tensor, sp, full_res: bool, mode: str):
    """The f32 stack from layer 1's plain output, layers 2-6 exact f32
    (stack._plain_layer) or emulated, layer 7 the f32 fold that the f32
    stacks end in (l7_fold_plain) -> Y s2d [N, hg, wg, 4]."""
    x = stack._l1_values(plane, sp, full_res).permute(0, 3, 1, 2)
    with torch.no_grad():
        for k in range(1, 6):
            x = (stack._plain_layer(x, *sp[k], torch.float32) if mode == "f32"
                 else _emulated_layer(x, *sp[k], mode))
        return stack.l7_fold_plain(x.permute(0, 2, 3, 1), sp.w7f, sp[6][1])


@pytest.mark.parametrize("model,full_res", [("noise2", True),
                                            ("scale2.0x", False)])
def test_split_products_hold_the_f32_bar(model, full_res):
    """On the shipped weights at full width, on an image-like plane: the
    three-term splits stay within 3e-5 of the f32 stack, one TF32 product
    does not."""
    params = load_model_json(ROOT / "models" / f"{model}_demo.json")
    sp = stack.prep_params(params, torch.float32, "cpu")
    side = 64 if full_res else 32
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    rng = np.random.default_rng(7)
    plane = torch.from_numpy(
        (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
         + 0.05 * rng.standard_normal((1, side, side))).astype(np.float32))
    ref = _stack(plane, sp, full_res, "f32")
    err = {mode: (_stack(plane, sp, full_res, mode) - ref).abs().max().item()
           for mode in ("split", "split_raw", "tf32")}
    assert err["split"] <= F32_TOL and err["split_raw"] <= F32_TOL
    assert err["tf32"] > F32_TOL
    # and the plain f32 stack is the wrappers' own f32 plain version
    wrapper = stack.stack_noise_s2d if full_res else stack.stack_scale
    assert (wrapper(plane, sp) - ref).abs().max().item() <= 1e-6


# --- the plan ----------------------------------------------------------------

def test_tf32_plan_is_the_kernels_table():
    """tf32_plan's chunk plan of each layer is the one csrc/mma_tf32.cu
    instantiates, and its shared memory fits the card."""
    src = (ROOT / "waifu2x_torch" / "csrc" / "mma_tf32.cu").read_text()
    table = {(int(ci), int(co)): (int(kc), int(st)) for ci, co, kc, st in
             re.findall(r"W2X_TF32_CASE\(\d, (\d+), (\d+), (\d+), (\d+)\)",
                        src)}
    assert sorted(table) == sorted(stack.WIDTHS[1:6])
    for (ci, co), (kc, st) in table.items():
        plan = stack.tf32_plan(ci, co)
        assert (plan.kc, plan.stages) == (kc, st)
        assert plan.tile == (16, 16) and plan.threads == 512
        assert plan.smem_bytes <= stack.SMEM_MAX
    # the ring of (window, w_hi, w_lo) and the a_lo window, or the tile
    p = stack.tf32_plan(128, 128)
    assert p.win_stride == 324
    assert p.smem_bytes == 2 * 2 * (324 + 2 * 9 * 128) * 16 + 2 * 324 * 16
    p = stack.tf32_plan(32, 32)
    assert p.smem_bytes == 2 * 2 * (324 + 2 * 9 * 32) * 16 + 2 * 324 * 16
    with pytest.raises(ValueError, match="no 3xTF32 kernel"):
        stack.tf32_plan(128, 1)


# --- the dispatch ------------------------------------------------------------

class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def _fake_launcher(calls, kind="noise"):
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = kind, None, 0
    run.libs = {name: _FakeLib(calls) for name in stack._ARGTYPES}
    run.bf16, run.stream = 0, 0
    return run


@pytest.mark.parametrize("shape", [(2, 27, 38), (1, 5, 300)],
                         ids=["27x38", "5x300"])
def test_f32_noise_stack_dispatch(sp32, shape):
    """Layers 2-6 of an f32 noise stack (any plane size, rounded up to
    even) on w2x_tf32_layer, 5 launches under MID_LAUNCHES["mma_tf32"].
    Layer 6 counts as the direct form, and layer 7 runs folded (csrc/l7.cu,
    FFMA)."""
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls)
    x = torch.zeros(1)
    n, ph, pw = shape
    hg, wg = -(-ph // 2), -(-pw // 2)
    for k in range(7):
        run.layer(k, True, x, sp32, x, n, ph, pw)
    names = [fn for fn, _ in calls]
    assert names == ["w2x_l1"] + ["w2x_tf32_layer"] * 5 + ["w2x_l7_fold"]
    assert stack.L7_LAUNCHES["fold_f32"] == 1
    assert stack.MID_LAUNCHES["mma_tf32"] == 5
    assert stack.MID_LAUNCHES["mma"] == 0
    assert stack.L6_LAUNCHES["direct"] == 1
    assert stack.LAUNCHES == stack.KERNEL_LAUNCHES["noise"] == 7
    for k, (_, args) in list(enumerate(calls))[1:6]:
        assert args[7:10] == (n, 2 * hg + 14 - 2 * k, 2 * wg + 14 - 2 * k)
    stack.reset_launches()


def test_f32_tensor_core_layers_have_no_variant(sp32):
    calls = []
    run = _fake_launcher(calls)
    x = torch.zeros(1)
    with pytest.raises(ValueError, match="no variant"):
        run.tf32_layer(3, x, sp32, x, 1, 20, 24, zs=1)
    with pytest.raises(ValueError, match="no f32 variant"):
        stack.mma_layer(torch.zeros(1, 6, 6, 64), sp32, 4, pp=True)
    assert not calls


def test_tf32_layer_alone_counts_as_no_stack_launch(sp32):
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls)
    run.kind = None
    x = torch.zeros(1)
    run.tf32_layer(5, x, sp32, x, 1, 20, 24, l6="direct")
    assert [fn for fn, _ in calls] == ["w2x_tf32_layer"]
    args = calls[0][1]
    assert args[:2] == (0, 5)
    assert args[3:5] == tuple(t.data_ptr() for t in sp32.wt[4])
    assert args[10] == stack.tf32_plan(128, 128).smem_bytes
    assert stack.MID_LAUNCHES["mma_tf32"] == 1
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())
    stack.reset_launches()


def test_tf32_layer_needs_the_split_weights(sp32, sp16):
    run = _fake_launcher([])
    x = torch.zeros(1)
    with pytest.raises(ValueError, match="wt"):
        run.tf32_layer(2, x, stack.StackParams(list(sp32)), x, 1, 20, 24)
    with pytest.raises(ValueError, match="wt"):
        run.tf32_layer(2, x, sp16, x, 1, 20, 24)


@pytest.mark.parametrize("k", range(2, 7))
def test_f32_mma_layer_on_cpu_is_the_f32_plain_layer(sp32, rng, k):
    """mma_layer takes f32 now (the 3xTF32 kernel on a card); on the CPU
    it is mma_layer_plain from sp.wm, which for f32 storage holds the f32
    weights: F.conv2d's function to f32 rounding."""
    ci, co = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((1, 9, 11, ci)).astype(
        np.float32))
    got = stack.mma_layer(x, sp32, k)
    assert got.dtype == torch.float32 and got.shape == (1, 7, 9, co)
    ref = stack._plain_layer(x.permute(0, 3, 1, 2), *sp32[k - 1],
                             torch.float32).permute(0, 2, 3, 1)
    assert (got - ref).abs().max().item() <= 1e-5
