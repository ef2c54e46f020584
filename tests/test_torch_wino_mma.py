"""The tensor-core Winograd layer 6 (B5 in bf16, csrc/wino.cu) on the CPU:
its weights (StackParams.w6m, pack_mma of pack_wino's U), the plain version
of its arithmetic (wino_layer_plain: V rounded to bf16 once, A^T folded per
output row, f32 sums) against _l6_wino_plain and the JAX Winograd body, its
plan against the kernel's constants, and which C entry each storage dtype
reaches (a fake library stands in for the card).

The JAX side runs its Pallas kernel in interpret mode, as the JAX suite does
on the CPU."""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_tpu.ops import s2d as js2d
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack

torch.set_num_threads(2)

WINO_CU = Path(stack.__file__).resolve().parents[1] / "csrc" / "wino.cu"


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


def _random_sp(seed: int, dtype):
    """Random weights at the flagship widths, unit-gain scale."""
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.standard_normal((3, 3, ci, co))
                     * np.sqrt(2.0 / (9 * ci))).astype(np.float32),
               "b": (0.01 * rng.standard_normal(co)).astype(np.float32)}
              for ci, co in stack.WIDTHS]
    return stack.prep_params(params, dtype, "cpu")


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


# --- weights ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_w6m_is_a_permutation_of_pack_wino(params_np, dtype):
    """pack_mma(U as [4, 4, 128, 128]) moves pack_wino's values and nothing
    else: unpacked, it is pack_wino(w6) (and the JAX package's) bit for bit,
    in the storage dtype, and w6w holds the same values."""
    sp = stack.prep_params(params_from_numpy(params_np), dtype, "cpu")
    w6 = np.asarray(params_np[5]["w"], np.float32)
    u = s2d.pack_wino(w6)
    np.testing.assert_array_equal(u, js2d.pack_wino(w6))
    assert tuple(sp.w6m.shape) == (16, 16, 128, 8)
    assert sp.w6m.dtype == dtype and sp.w6m.is_contiguous()
    want = torch.from_numpy(u).to(dtype)
    assert torch.equal(stack.unpack_w6m(sp.w6m), want)
    assert torch.equal(stack.unpack_w6m(sp.w6m), sp.w6w)
    # the C order: [c8][p][co][k] = U[p][WINO_CI_ORDER[8 c8 + k]][co]
    assert torch.equal(sp.w6m[3, 5, 7, 2],
                       want[5, stack.WINO_CI_ORDER[26], 7])
    assert torch.equal(s2d.unpack_mma(sp.w6m), want[:, stack.WINO_CI_ORDER])


def test_wino_ci_order():
    """Logical channel 8h + 2j + e of each chunk of 16 holds physical
    channel 4j + 2h + e: an A-fragment thread's k = 2j, 2j+1 and 2j+8, 2j+9
    are the four channels 4j .. 4j+3 that it loads in one piece."""
    order = stack.WINO_CI_ORDER
    assert sorted(order.tolist()) == list(range(128))
    for c in range(8):
        for j in range(4):
            ks = [16 * c + 2 * j, 16 * c + 2 * j + 1, 16 * c + 2 * j + 8,
                  16 * c + 2 * j + 9]
            assert order[ks].tolist() == [16 * c + 4 * j + e
                                          for e in range(4)]


# --- the plain version of the kernel's arithmetic ---------------------------

@pytest.mark.parametrize("shape", [(1, 12, 14), (2, 26, 18)],
                         ids=["12x14", "2x26x18"])
def test_wino_layer_plain_matches_l6_wino_plain(shape):
    """wino_layer_plain (A^T folded per output row, V in the kernel's add
    order) against _l6_wino_plain's bf16 form (V rounded once, M[p] then
    A^T M A) before the output's rounding: within 1e-5 of the output's
    magnitude, on random weights; rounded, within one bf16 ulp."""
    sp = _random_sp(11, torch.bfloat16)
    rng = np.random.default_rng(12)
    x5 = torch.from_numpy(rng.random((*shape, 128), dtype=np.float32)
                          ).to(torch.bfloat16)
    got = stack.wino_layer_plain(x5, sp.w6m, sp[5][1], round_out=False)
    ref = stack._l6_wino_plain(x5.float().permute(0, 3, 1, 2), sp,
                               torch.bfloat16, round_out=False, round_v=True
                               ).permute(0, 2, 3, 1)
    assert got.shape == (shape[0], shape[1] - 2, shape[2] - 2, 128)
    scale = ref.abs().max().item()
    assert scale > 0.1
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    r16 = stack.wino_layer_plain(x5, sp.w6m, sp[5][1])
    assert r16.dtype == torch.bfloat16
    diff = (r16.float() - ref.to(torch.bfloat16).float()).abs()
    assert diff.max().item() <= 2.0 ** -8 * scale


def test_v_rounding_follows_the_kernel(monkeypatch):
    """_l6_wino_plain rounds V to its dtype only with round_v; the plain
    stacks pass it where bf16 calls reach the tensor-core kernel, and never
    in f32, where the 3xTF32 kernel keeps V in f32. Rounding V moves the
    output, within the bf16 bar."""
    sp = _random_sp(13, torch.bfloat16)
    rng = np.random.default_rng(14)
    x5 = torch.from_numpy(rng.random((1, 128, 10, 12), dtype=np.float32)
                          ).to(torch.bfloat16).float()
    out = {rv: stack._l6_wino_plain(x5, sp, torch.bfloat16, round_out=False,
                                    round_v=rv) for rv in (True, False)}
    out["f32"] = stack._l6_wino_plain(x5, sp, torch.float32, round_out=False)
    assert torch.equal(out[False], out["f32"])
    d = (out[True] - out[False]).abs().max().item()
    assert 0 < d <= 2.0 ** -4
    # the stacks' plain versions: V rounded in bf16 only
    seen = []
    plain = stack._l6_wino_plain

    def spy(*args, **kw):
        seen.append((args[2], kw.get("round_v", False)))
        return plain(*args, **kw)

    monkeypatch.setattr(stack, "_l6_wino_plain", spy)
    sp32 = _random_sp(13, torch.float32)
    y = torch.from_numpy(rng.random((1, 6, 7), dtype=np.float32))
    stack.stack_scale(y.to(torch.bfloat16), sp, l6_wino=True)
    stack.stack_scale(y, sp32, l6_wino=True)
    assert seen == [(torch.bfloat16, True), (torch.float32, False)]


def test_v_rounded_once_is_exact_for_bf16_sums():
    """Where a window holds values k/8 (bf16-exact sums), V needs no
    rounding: the kernel's arithmetic equals the transform's with V kept in
    f32 to the f32 sums' spread."""
    sp = _random_sp(15, torch.bfloat16)
    rng = np.random.default_rng(16)
    x5 = torch.from_numpy(rng.integers(0, 9, (1, 10, 10, 128)).astype(
        np.float32) / 8).to(torch.bfloat16)
    got = stack.wino_layer_plain(x5, sp.w6m, sp[5][1], round_out=False)
    ref = stack._l6_wino_plain(x5.float().permute(0, 3, 1, 2), sp,
                               torch.bfloat16, round_out=False
                               ).permute(0, 2, 3, 1)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# --- against the JAX kernel -------------------------------------------------

def test_wino_bf16_stack_matches_pallas_interpret(params_np, sp16, sp32,
                                                  rng):
    """The bf16 B5 stack (V rounded once) against the JAX
    kernel in interpret mode with bf16 weights and l6_wino=True (V formed
    with bf16 adds) at 2 x 13 x 22: the two differ only in where V is
    rounded. max |diff| <= 2^-4 (the JAX suite's bf16 bar) and both >= 50 dB
    against the f32 direct stack."""
    ylow = rng.random((2, 13, 22), dtype=np.float32)
    y16 = torch.from_numpy(ylow).to(torch.bfloat16)
    got = stack.stack_scale(y16, sp16, l6_wino=True).float()
    arrays, spec = jps.prep_params(params_np, scale_input=True,
                                   dtype=jnp.bfloat16)
    xcol = jps._xcol_scale(jnp.asarray(y16.float().numpy(), jnp.bfloat16),
                           16, 16)
    ref = jps._run_stack(xcol, arrays, 16, 16, 1, 2, spec, interpret=True,
                         l6_wino=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))[:, :13, :22]
    direct32 = stack.stack_scale(torch.from_numpy(ylow), sp32)
    assert got.shape == ref.shape == direct32.shape
    assert (got - ref).abs().max().item() <= 2.0 ** -4
    assert _psnr(got, direct32) >= 50.0
    assert _psnr(ref, direct32) >= 50.0


# --- the plan, the grid and the dispatch ------------------------------------

def test_wino_plan_matches_the_kernel():
    """wino_plan's tile, unit channels and chunk are, for each storage
    dtype, the constants its csrc/wino.cu kernel compiles with; each kernel
    owns its shared memory (no count crosses to the C entries), and the
    ring that these constants give fits the card."""
    src = WINO_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split("*")[-1].split("/")[-1])

    for dtype, (co, kc, stages, elem) in {
            torch.bfloat16: ("WN", "WKC", "WSTAGES", 2),
            torch.float32: ("QN", "QKC", "QSTAGES", 4)}.items():
        plan = stack.wino_plan(dtype)
        assert plan.tile == (const("WT"), const("WT")) == (8, 8)
        assert (plan.co, plan.kc) == (const(co), const(kc))
        win = (2 * plan.tile[0] + 2) ** 2 * plan.kc * elem
        # U's chunk for the unit's channels: bf16 once, f32 hi and lo
        u = (plan.kc // 8) * 16 * plan.co * 16 * (1 if elem == 2 else 2)
        out_tile = (2 * plan.tile[0]) ** 2 * (plan.co * elem + 16)
        assert const(stages) * (win + u) + out_tile <= stack.SMEM_MAX
    assert stack.wino_plan() == stack.wino_plan(torch.bfloat16)
    assert (stack.wino_plan().co, stack.wino_plan(torch.float32).co) == (
        64, 32)
    assert "smem_bytes" not in src
    for name in ("WSMEM", "QSMEM"):
        assert f"static_assert({name} <= 232448" in src


class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.mark.parametrize("bf16,plane", [
    (True, (3, 20, 36)), (True, (2, 78, 110)),
    (False, (3, 20, 36)), (False, (2, 78, 110))],
    ids=["bf16", "bf16-37x53", "f32", "f32-37x53"])
def test_wino_dispatch(sp16, sp32, bf16, plane):
    """bf16 calls reach the bf16 tensor-core Winograd kernel and f32 calls
    the 3xTF32 one, on a small layer-5 plane and on the one of a 37 x 53
    scale stack. Each launch counts under L6_LAUNCHES["wino"] (the form) and
    WINO_LAUNCHES by kernel; the entries get w6m or w6t's two halves and no
    shared-memory count."""
    stack.reset_launches()
    sp = sp16 if bf16 else sp32
    kind = "mma" if bf16 else "mma_tf32"
    calls = []
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "scale", None, 0
    run.libs = {name: _FakeLib(calls) for name in stack._ARGTYPES}
    run.bf16, run.stream = int(bf16), 0
    x = torch.zeros(1, dtype=sp[0][0].dtype)
    run.wino(x, sp, x, *plane, "wino")
    assert [fn for fn, _ in calls] == [
        "w2x_l6_wino_mma" if bf16 else "w2x_l6_wino_tf32"]
    assert stack.L6_LAUNCHES["wino"] == 1 and stack.LAUNCHES == 1
    assert stack.WINO_LAUNCHES == {k: int(k == kind)
                                   for k in ("mma", "mma_tf32")}
    args = calls[0][1]
    if bf16:
        # (bf16, x5, um, b, y6, n, H5, W5, stream)
        assert args[0] == 1 and args[2] == sp.w6m.data_ptr()
        assert args[5:] == (*plane, 0)
    else:
        # (bf16, x5, uhi, ulo, b, y6, n, H5, W5, stream)
        assert args[0] == 0 and args[2:4] == tuple(
            t.data_ptr() for t in sp.w6t)
        assert args[4] == sp[5][1].data_ptr()
        assert args[6:] == (*plane, 0)
    stack.reset_launches()
    assert stack.WINO_LAUNCHES == {"mma": 0, "mma_tf32": 0}


def test_wino_layer_on_cpu():
    """wino_layer on CPU tensors is its plain version, adds no launch, and
    refuses what the kernel does not take."""
    sp = _random_sp(17, torch.bfloat16)
    rng = np.random.default_rng(18)
    x5 = torch.from_numpy(rng.random((1, 8, 12, 128), dtype=np.float32)
                          ).to(torch.bfloat16)
    stack.reset_launches()
    assert torch.equal(stack.wino_layer(x5, sp),
                       stack.wino_layer_plain(x5, sp.w6m, sp[5][1]))
    assert stack.WINO_LAUNCHES == {"mma": 0, "mma_tf32": 0}
    assert stack.LAUNCHES == 0
    with pytest.raises(ValueError, match="even"):
        stack.wino_layer(x5[:, :7], sp)
    with pytest.raises(TypeError, match="bfloat16"):
        stack.wino_layer(x5.float(), sp)   # f32 values, bf16 weights
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        stack.wino_layer(x5.half(), sp)
    with pytest.raises(ValueError, match="w6m"):
        stack.wino_layer(x5, stack.StackParams(list(sp)))


def test_bf16_stacks_under_both_kernels_agree(sp16, rng, monkeypatch):
    """The bf16 stack's plain version with V rounded once (the tensor-core
    kernel's) against the same stack with V kept in f32: within 2^-4, the
    bf16 bar."""
    y = torch.from_numpy(rng.random((1, 11, 17), dtype=np.float32)
                         ).to(torch.bfloat16)
    rounded = stack.stack_scale(y, sp16, l6_wino=True).float()
    plain = stack._l6_wino_plain

    def v_in_f32(*args, **kw):
        return plain(*args, **{**kw, "round_v": False})

    monkeypatch.setattr(stack, "_l6_wino_plain", v_in_f32)
    kept = stack.stack_scale(y, sp16, l6_wino=True).float()
    assert not torch.equal(rounded, kept)
    assert (rounded - kept).abs().max().item() <= 2.0 ** -4
