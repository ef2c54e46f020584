"""B5's Winograd layer 6 in f32 on the tensor cores as 3xTF32
(csrc/wino.cu's l6_wino_tf32) on the CPU: its weights (StackParams.w6t, the
hi and lo halves of pack_wino's U in the kernel's channel order), a plain
emulation of the kernel's arithmetic over whole f32 B5 stacks of the shipped
models against the f32 plain version and the JAX f32 kernel in interpret
mode, its plan against the kernel's constants, and which C entry each f32
stack call reaches (a fake library stands in for the card).

The emulation forms V as the kernel does (B^T along the window's rows, then
along its columns, one f32 add each, never rounded), splits it as the kernel
splits it in registers, v_hi = rna(V), v_lo = rna(V - v_hi), takes U's
halves from w6t, cuts every operand to TF32 as wgmma reads an f32 value (a
no-op on these), and sums v_lo*u_hi + v_hi*u_lo + v_hi*u_hi in f64, A^T
folded per output row as the kernel folds it. "tf32" is one TF32 product of
the cut operands: the tensor cores on f32 operands. Bars: the split within
3e-5 of the f32 plain stack and of the JAX f32 kernel (the JAX kernel
suite's f32 bar), one TF32 product not; hi + lo within 2^-21 of U,
relative. The CUDA kernel itself is held against the f32 plain version on
the card by chip_smoke.py (phase 27)."""

from __future__ import annotations

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.weights import load_model_json as jax_load_model
from waifu2x_tpu.models.srcnn import as_numpy
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack
from waifu2x_torch.ops.convstack import leaky_relu

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WINO_CU = ROOT / "waifu2x_torch" / "csrc" / "wino.cu"
F32_TOL = 3e-5


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its low 13 mantissa bits dropped: an f32 operand as wgmma
    reads it as TF32."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


@pytest.fixture(scope="module")
def sp32():
    return stack.prep_params(init_params(3), torch.float32, "cpu")


@pytest.fixture(scope="module")
def shipped():
    """The shipped weights as the JAX package loads them, and the port's
    f32 StackParams of them, by model."""
    out = {}
    for model in ("noise2", "scale2.0x"):
        pj = as_numpy(jax_load_model(ROOT / "models" / f"{model}_demo.json"))
        out[model] = (pj, stack.prep_params(params_from_numpy(pj),
                                            torch.float32, "cpu"))
    return out


# --- the weights -------------------------------------------------------------

def test_w6t_is_the_split_of_pack_wino(sp32):
    """w6t's halves are TF32 values (their low 13 bits zero), hi = rna(U),
    and hi + lo is U to 2^-21 relative, in the natural channel order after
    unpack_w6t; bf16 weights have no w6t."""
    hi, lo = sp32.w6t
    assert hi.shape == lo.shape == (32, 16, 128, 4)
    assert hi.dtype == lo.dtype == torch.float32
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    u = sp32.w6w                                        # pack_wino's U, f32
    back = stack.unpack_w6t(sp32.w6t)
    assert ((back - u).abs() <= 2.0 ** -21 * u.abs()).all()
    assert not torch.equal(stack.unpack_w6t((hi, torch.zeros_like(lo))), u)
    order = stack.WINO_TF32_CI_ORDER
    hi_nat = torch.empty_like(u)
    hi_nat[:, order] = s2d.unpack_mma(hi)
    assert torch.equal(hi_nat, s2d.tf32_round(u))
    sp16 = stack.prep_params(init_params(3), torch.bfloat16, "cpu")
    assert sp16.w6t is None


def test_wino_tf32_ci_order():
    """Within each chunk of 8, logical channel k = t (t = 0..3) holds
    physical channel 2t and k = t + 4 holds 2t + 1: the two channels a
    thread reads in one 8-byte load are its fragment's k = t and t + 4."""
    order = stack.WINO_TF32_CI_ORDER
    assert sorted(order.tolist()) == list(range(128))
    for c in range(16):
        for t in range(4):
            assert order[8 * c + t] == 8 * c + 2 * t
            assert order[8 * c + t + 4] == 8 * c + 2 * t + 1


# --- the emulation -----------------------------------------------------------

def _emulated_l6(x5: torch.Tensor, sp, mode: str) -> torch.Tensor:
    """Layer 6 as the f32 Winograd kernel computes it, on f32 values
    [N, 128, H, W] -> [N, 128, H-2, W-2] (see the module docstring);
    mode "split" (the kernel's three TF32 terms) or "tf32" (one)."""
    n, c, h5, w5 = x5.shape
    hb, wb = (h5 - 2) // 2, (w5 - 2) // 2
    xs = x5.permute(0, 2, 3, 1)
    u = sp.w6w.float()
    u_hi = tf32_cut(s2d.tf32_round(u)).double()
    u_lo = tf32_cut(s2d.tf32_round(u - s2d.tf32_round(u))).double()

    def win(r, col):
        return xs[:, r:r + 2 * hb:2, col:col + 2 * wb:2]

    m = {}
    for py in range(4):
        t = [stack._bt_row(py, [win(r, col) for r in range(4)])
             for col in range(4)]
        for px in range(4):
            v = stack._bt_row(px, t)
            p = py * 4 + px
            if mode == "tf32":
                m[py, px] = tf32_cut(v).double() @ tf32_cut(u[p]).double()
                continue
            v_hi = s2d.tf32_round(v)
            v_lo = s2d.tf32_round(v - v_hi)
            v_hi, v_lo = tf32_cut(v_hi).double(), tf32_cut(v_lo).double()
            m[py, px] = v_lo @ u_hi[p] + v_hi @ u_lo[p] + v_hi @ u_hi[p]
    out = xs.new_empty((n, hb, 2, wb, 2, c), dtype=torch.float64)
    for a in (0, 1):
        r = [sum(stack._WINO_AT[a][py] * m[py, px] for py in range(4))
             for px in range(4)]
        out[:, :, a, :, 0] = r[0] + r[1] + r[2]
        out[:, :, a, :, 1] = r[1] - r[2] - r[3]
    y = out.reshape(n, 2 * hb, 2 * wb, c).float() + sp[5][1]
    return leaky_relu(y).permute(0, 3, 1, 2)


def _stack(plane: torch.Tensor, sp, full_res: bool, mode: str):
    """The f32 B5 stack from layer 1's plain output: layers 2-5 exact f32,
    layer 6 the f32 plain Winograd (mode "f32") or emulated, layer 7 the
    fold -> Y s2d [N, hg, wg, 4]."""
    x = stack._l1_values(plane, sp, full_res).permute(0, 3, 1, 2)
    with torch.no_grad(), stack.no_tf32():
        for k in range(1, 5):
            x = stack._plain_layer(x, *sp[k], torch.float32)
        x = (stack._l6_wino_plain(x, sp, torch.float32) if mode == "f32"
             else _emulated_l6(x, sp, mode))
        return stack.l7_fold_plain(x.permute(0, 2, 3, 1), sp.w7f, sp[6][1])


def _image_plane(side: int, seed: int) -> torch.Tensor:
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
         + 0.05 * rng.standard_normal((1, side, side))).astype(np.float32))


def _jax_b5(pj, plane: torch.Tensor, full_res: bool) -> torch.Tensor:
    """The JAX f32 kernel with l6_wino=True in interpret mode on the same
    plane (16 x 16 tiles), cropped -> [N, hg, wg, 4]."""
    arrays, spec = jps.prep_params(pj, scale_input=not full_res,
                                   dtype=jnp.float32)
    y = jnp.asarray(plane.numpy())
    hl, wl = (plane.shape[1] // 2, plane.shape[2] // 2) if full_res else (
        plane.shape[1], plane.shape[2])
    ny, nx = -(-hl // 16), -(-wl // 16)
    xcol = (jps._xcol_noise(y, 16, 16) if full_res
            else jps._xcol_scale(y, 16, 16))
    out = jps._run_stack(xcol, arrays, 16, 16, ny, nx, spec, interpret=True,
                         l6_wino=True)
    return torch.from_numpy(np.array(out, np.float32))[:, :hl, :wl]


@pytest.mark.parametrize("model,full_res", [("noise2", True),
                                            ("scale2.0x", False)])
def test_split_products_hold_the_f32_bar(shipped, model, full_res):
    """On the shipped weights at full width, on an image-like plane: the f32
    B5 stack with layer 6 as the kernel's three-term split stays within 3e-5
    of the f32 plain version and of the JAX f32 B5 kernel in interpret mode;
    one TF32 product does not. The f32 plain stack is the wrappers' own."""
    pj, sp = shipped[model]
    plane = _image_plane(32 if full_res else 16, 7)
    ref = _stack(plane, sp, full_res, "f32")
    split = _stack(plane, sp, full_res, "split")
    err = (split - ref).abs().max().item()
    err_tf32 = (_stack(plane, sp, full_res, "tf32") - ref).abs().max().item()
    assert 0 < err <= F32_TOL
    assert err_tf32 > F32_TOL
    jax_ref = _jax_b5(pj, plane, full_res)
    assert (split - jax_ref).abs().max().item() <= F32_TOL
    wrapper = stack.stack_noise_s2d if full_res else stack.stack_scale
    assert (wrapper(plane, sp, l6_wino=True) - ref).abs().max().item() <= 1e-6


def test_split_layer_alone_on_random_weights(sp32):
    """Layer 6 alone on random-init weights and a [0, 1) plane: the split
    within 3e-5 of the f32 plain Winograd (whose V is never rounded), and
    wino_layer on f32 CPU tensors is the f32 plain version of the kernel's
    arithmetic (wino_layer_plain, A^T folded), within 1e-5 of
    _l6_wino_plain."""
    rng = np.random.default_rng(21)
    x5 = torch.from_numpy(rng.random((1, 12, 18, 128), dtype=np.float32))
    ref = stack._l6_wino_plain(x5.permute(0, 3, 1, 2), sp32, torch.float32)
    got = _emulated_l6(x5.permute(0, 3, 1, 2), sp32, "split")
    assert (got - ref).abs().max().item() <= F32_TOL
    alone = stack.wino_layer(x5, sp32)
    assert alone.dtype == torch.float32 and alone.shape == (1, 10, 16, 128)
    assert torch.equal(alone, stack.wino_layer_plain(x5, sp32.w6m,
                                                     sp32[5][1]))
    assert (alone - ref.permute(0, 2, 3, 1)).abs().max().item() <= 1e-5


# --- the plan ----------------------------------------------------------------

def test_f32_plan_is_the_kernels_table():
    """wino_plan(float32) is the f32 kernel's unit (8 x 8 blocks, a quarter
    of the channels) and chunk (8 channels, one k8 step), as csrc/wino.cu
    compiles them; the kernel instantiates m64n32k8 TF32 products with A
    from registers, and owns its shared memory."""
    src = WINO_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split("/")[-1].strip())

    plan = stack.wino_plan(torch.float32)
    assert plan.tile == (const("WT"), const("WT"))
    assert (plan.co, plan.kc) == (const("QN"), const("QKC")) == (32, 8)
    assert "mma_k8_tf32_rs32" in src and "l6_wino_tf32" in src
    stages = const("QSTAGES")
    ring = stages * ((18 * 18 * 8 * 4) + 2 * (8 // 4) * 16 * 32 * 16)
    assert ring + 16 * 16 * (32 * 4 + 16) <= stack.SMEM_MAX


# --- the dispatch ------------------------------------------------------------

class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """stack._launch on CPU tensors as on the card: every _Launcher's
    libraries are fakes that record their calls, and torch.cuda.device is
    a no-op."""
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


@pytest.mark.parametrize("shape", [(1, 20, 36), (2, 37, 53)],
                         ids=["20x36", "37x53"])
@pytest.mark.parametrize("kind", ["scale", "noise", "dense", "fused_u8"])
def test_f32_wino_stack_dispatch(sp32, fake_card, kind, shape):
    """Layer 6 of every f32 stack call under l6_wino reaches the 3xTF32
    Winograd kernel (w2x_l6_wino_tf32, with w6t's halves and layer 5's
    plane, rounded up to even on the noise stack), counted under
    WINO_LAUNCHES["mma_tf32"]."""
    n, h, w = shape
    x = torch.zeros((n, h, w))
    uvp = torch.zeros((n, h, w, 8))
    stack._launch(x, sp32, kind, None, uvp=uvp if kind == "fused_u8" else None,
                  tc=32 if kind == "dense" else 0, form="wino")
    names = [fn for fn, _ in fake_card]
    assert names[5] == "w2x_l6_wino_tf32"
    assert names.count("w2x_l6_wino_tf32") == 1
    assert stack.WINO_LAUNCHES == {"mma": 0, "mma_tf32": 1}
    assert stack.L6_LAUNCHES["wino"] == 1
    hg, wg = (-(-h // 2), -(-w // 2)) if kind == "noise" else (h, w)
    args = fake_card[5][1]
    # (bf16, x5, uhi, ulo, b, y6, n, H5, W5, stream)
    assert args[0] == 0
    assert args[2:4] == tuple(t.data_ptr() for t in sp32.w6t)
    assert args[6:] == (n, 2 * hg + 4, 2 * wg + 4, 0)


# --- the probe tool ----------------------------------------------------------

def test_wino_tf32_probe_rehearses_on_cpu(capsys):
    """tools/wino_tf32_probe.py on the CPU: the kernel's CPU path against
    the plain version on a small real layer-5 plane, no build, no timing;
    its two builds' switches exist in the kernel's source."""
    from waifu2x_torch.tools import wino_tf32_probe
    assert wino_tf32_probe.main(["--device", "cpu", "--size", "12"]) == 0
    assert "nothing timed" in capsys.readouterr().out
    src = WINO_CU.read_text()
    for flag in wino_tf32_probe.VARIANTS.values():
        assert f"#ifndef {flag[2:]}" in src
