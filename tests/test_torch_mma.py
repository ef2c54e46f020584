"""Layers 2-6 on the tensor cores (waifu2x_torch/csrc/mma.cu) as far as the
CPU reaches them: the weight packer, the plain version from the packed
weights, the shared-memory plan the C entry is launched with, the dispatch
by dtype and its launch counts, and the mma_chain probe's plain version.

Tolerances: in f32 the plain version from the packed weights is held to
1e-5 against F.conv2d (a wrong tap or channel order is off by the size of
the values); in bf16 to one bf16 ulp at the output's magnitude, because the
two sum the same exact products in another order and a sum next to a
rounding boundary may land on either side; where the terms cancel to an
output near zero the f32 sums' own spread (1e-5 for values of order 1) is
more than that ulp and is what is allowed. Whole stacks are held against
the JAX package at the bars of tests/test_torch_stack.py: f32 3e-5, bf16
storage >= 50 dB (peak 1) against f32. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER, as_numpy, init_params
from waifu2x_tpu.ops.convstack import convert_plane as jconvert_plane
from waifu2x_tpu.ops.pallas_stack import prep_params as jprep_params
from waifu2x_tpu.ops.pallas_stack import stack_scale as jstack_scale
from waifu2x_torch.models.weights import load_model_json, params_from_numpy
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import d2s, pack_mma, unpack_mma
from waifu2x_torch.tools import mma_probe

torch.set_num_threads(2)

MID = list(range(2, 7))                       # the layers the kernel runs
ODD_SHAPES = [(1, 27, 38), (2, 37, 53), (1, 5, 300)]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), WAIFU2X_7LAYER))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def sp16(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 (8 significant bits) at |v|."""
    mag = v.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("k", MID)
def test_pack_mma_round_trip_and_tap_order(params_np, k):
    w = torch.from_numpy(params_np[k - 1]["w"].copy())       # [3, 3, ci, co]
    ci, co = stack.WIDTHS[k - 1]
    wp = pack_mma(w)
    assert wp.shape == (ci // 8, 9, co, 8) and wp.is_contiguous()
    # out[c8, dy*3 + dx, o, j] == w[dy, dx, 8*c8 + j, o]
    assert wp[ci // 8 - 1, 5, 3, 6] == w[1, 2, ci - 2, 3]
    assert wp[0, 6, co - 1, 0] == w[2, 0, 0, co - 1]
    torch.testing.assert_close(unpack_mma(wp), w.reshape(9, ci, co),
                               rtol=0, atol=0)
    # a chunk of 16 input channels is one contiguous run of the packed array
    chunk = wp.reshape(-1)[:2 * 9 * co * 8].reshape(2, 9, co, 8)
    torch.testing.assert_close(unpack_mma(chunk), w.reshape(9, ci, co)[:, :16],
                               rtol=0, atol=0)


def test_pack_mma_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_mma(torch.zeros(3, 3, 12, 8))
    with pytest.raises(ValueError, match="kh, kw, ci, co"):
        pack_mma(torch.zeros(9, 16, 8))


def test_prep_params_packs_the_mid_layers(params_np, sp16, sp32):
    for sp, dtype in ((sp16, torch.bfloat16), (sp32, torch.float32)):
        assert len(sp.wm) == 5
        for k, wp in zip(MID, sp.wm):
            assert wp.dtype == dtype
            # the packed weights are the layer's own, in its storage dtype
            torch.testing.assert_close(
                unpack_mma(wp).permute(1, 0, 2).contiguous(), sp[k - 1][0],
                rtol=0, atol=0)


@pytest.mark.parametrize("shape", ODD_SHAPES)
@pytest.mark.parametrize("k", MID)
def test_mma_layer_plain_matches_plain_layer_f32(sp32, rng, k, shape):
    ci, _ = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((*shape, ci), dtype=np.float32))
    got = stack.mma_layer_plain(x, sp32.wm[k - 2], sp32[k - 1][1])
    ref = stack._plain_layer(x.permute(0, 3, 1, 2), *sp32[k - 1],
                             torch.float32).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (shape[0], shape[1] - 2, shape[2] - 2,
                                      stack.WIDTHS[k - 1][1])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", MID)
def test_mma_layer_plain_matches_plain_layer_bf16(sp16, rng, k):
    """bf16 storage: the products are exact in f32 on both sides and only
    the order of the f32 sums differs, so the stored outputs agree within
    one bf16 ulp at their own magnitude (or the f32 sums' spread, 1e-5,
    where the terms cancel), and nearly all are equal."""
    ci, _ = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((2, 19, 23, ci),
                                             dtype=np.float32)
                         ).to(torch.bfloat16)
    got = stack.mma_layer(x, sp16, k)        # a CPU tensor: the plain version
    assert got.dtype == torch.bfloat16
    ref = stack._plain_layer(x.float().permute(0, 3, 1, 2), *sp16[k - 1],
                             torch.bfloat16).permute(0, 2, 3, 1)
    diff = (got.float() - ref).abs()
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.abs()))
    assert bool((diff <= ulp.clamp_min(1e-5)).all())
    assert (diff > 0).float().mean().item() < 0.02


@pytest.mark.parametrize("hl,wl", [(16, 16), (13, 22), (9, 9), (5, 31)])
def test_scale_stack_from_packed_weights_matches_convert_plane(
        params_np, sp32, rng, hl, wl):
    ylow = rng.random((2, hl, wl), dtype=np.float32)
    up = np.repeat(np.repeat(ylow, 2, axis=1), 2, axis=2)
    ref = np.asarray(jconvert_plane(jnp.asarray(up), params_np,
                                    precision="highest"))
    got = d2s(stack.stack_scale_plain(torch.from_numpy(ylow), sp32,
                                      mma=True))[..., 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


def test_scale_stack_from_packed_weights_matches_pallas_interpret(
        params_np, sp32, rng):
    ylow = rng.random((2, 13, 22), dtype=np.float32)
    kp, spec = jprep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jstack_scale(jnp.asarray(ylow), kp, spec, tile=(16, 16),
                                  interpret=True))
    got = stack.stack_scale_plain(torch.from_numpy(ylow), sp32, mma=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("n,h,w", [(2, 16, 24), (1, 27, 38), (1, 5, 300)])
def test_noise_stack_from_packed_weights_matches_convert_plane(
        params_np, sp32, rng, n, h, w):
    y = rng.random((n, h, w), dtype=np.float32)
    ref = np.asarray(jconvert_plane(jnp.asarray(y), params_np,
                                    precision="highest"))
    got = stack.stack_noise_plain(torch.from_numpy(y), sp32, mma=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
    if h % 2 == 0 and w % 2 == 0:
        s2 = stack.stack_noise_s2d_plain(torch.from_numpy(y), sp32, mma=True)
        np.testing.assert_allclose(d2s(s2)[..., 0].numpy(), ref, rtol=0,
                                   atol=3e-5)


@pytest.mark.parametrize("model,scale", [("scale2.0x", True),
                                         ("noise1", False)])
def test_bf16_stack_from_packed_weights_fidelity(rng, model, scale):
    """The shipped weights in bf16 storage with layers 2-6 from the packed
    weights: >= 50 dB against f32, and within 2^-6 of the bf16 stack with
    F.conv2d layers (a tie flips one bf16 unit of some activation)."""
    params = load_model_json(Path(__file__).resolve().parents[1] / "models"
                             / f"{model}_demo.json")
    yy, xx = np.mgrid[0:24, 0:40].astype(np.float32)
    y = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
         + 0.02 * rng.standard_normal((24, 40))).astype(np.float32)[None]
    plain = stack.stack_scale_plain if scale else stack.stack_noise_s2d_plain
    y32 = plain(torch.from_numpy(y),
                stack.prep_params(params, torch.float32, "cpu"))
    sp = stack.prep_params(params, torch.bfloat16, "cpu")
    y16 = torch.from_numpy(y).to(torch.bfloat16)
    got = plain(y16, sp, mma=True)
    assert got.dtype == torch.bfloat16
    mse = torch.mean((got.double() - y32.double()) ** 2).item()
    assert 10 * np.log10(1.0 / mse) >= 50.0
    assert (got.float() - plain(y16, sp).float()).abs().max() <= 2.0 ** -6


@pytest.mark.parametrize("k", MID)
def test_mma_plan_fits_shared_memory(k):
    ci, co = stack.WIDTHS[k - 1]
    plan = stack.mma_plan(ci, co)
    kc, stages = plan.kc, plan.stages
    assert plan.tile == (16, 16) and plan.threads == 512
    # whole k16 steps, whole chunks, at most 8 channel groups a chunk, and
    # no more buffers than chunks
    assert kc % 16 == 0 and ci % kc == 0 and kc <= 64
    assert stages == 1 or 2 <= stages <= ci // kc
    k8c = kc // 8
    # the k8 stride holds the 18 x 18 window and spreads a quarter-warp's
    # 8 copies (k8c channel groups of 8 / k8c pixels) over 8 bank groups
    assert plan.win_stride >= 18 * 18
    groups = {(g * plan.win_stride + p) % 8
              for g in range(k8c) for p in range(8 // k8c)}
    assert len(groups) == 8
    ring = stages * k8c * (plan.win_stride + 9 * co) * 16
    assert plan.smem_bytes == max(ring, 256 * (2 * co + 16))
    assert plan.smem_bytes <= stack.SMEM_MAX == 232448
    # two blocks of a CO <= 64 layer fit one SM (228 KB, 1 KB a block kept)
    if co <= 64:
        assert 2 * (plan.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("ci,co", [(32, 48), (1, 32), (128, 1), (64, 32),
                                   (128, 64)])
def test_mma_plan_rejects(ci, co):
    """Only the five mid-layer widths have a tensor-core kernel."""
    with pytest.raises(ValueError):
        stack.mma_plan(ci, co)


@pytest.mark.parametrize("n,hin,win", [(1, 27, 38), (2, 37, 53), (1, 5, 300),
                                       (16, 1036, 1036), (256, 268, 268),
                                       (3, 18, 18), (1, 19, 35)])
def test_mma_grid_covers_ragged_shapes(n, hin, win):
    nty, ntx, blocks = stack.mma_grid(n, hin, win)
    assert blocks == n * nty * ntx
    for tiles, out in ((nty, hin - 2), (ntx, win - 2)):
        assert 16 * tiles >= out > 16 * (tiles - 1)


def test_mma_chain_plain_matches_numpy(rng):
    x = rng.standard_normal((256, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 128, 128)) * 0.1).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wp = stack.pack_chain(wt)
    assert wp.shape == (3, 16, 1, 128, 8)
    ref = sum(xt.float().numpy().astype(np.float64)
              @ wt[p].float().numpy().astype(np.float64) for p in range(3))
    got = stack.mma_chain(xt, wp)            # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (256, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["rows", "cols", "dtype", "packing"])
def test_mma_chain_rejects_bad_input(case):
    x = torch.zeros(256, 128, dtype=torch.bfloat16)
    wp = torch.zeros(2, 16, 1, 128, 8, dtype=torch.bfloat16)
    bad = {"rows": (ValueError, x[:100], wp),
           "cols": (ValueError, torch.zeros(256, 64, dtype=torch.bfloat16),
                    wp),
           "dtype": (TypeError, x.float(), wp),
           "packing": (ValueError, x, wp.reshape(2, 16, 128, 8))}[case]
    with pytest.raises(bad[0]):
        stack.mma_chain(bad[1], bad[2])


@pytest.mark.parametrize("case", ["layer", "channels", "dtype", "small",
                                  "no_packed_weights"])
def test_mma_layer_rejects_bad_input(sp16, case):
    x = torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16)
    bad = {"layer": (ValueError, x, sp16, 1),
           "channels": (ValueError, x, sp16, 4),
           "dtype": (TypeError, x.float(), sp16, 2),
           "small": (ValueError, x[:, :2], sp16, 2),
           "no_packed_weights": (ValueError, x, tuple(sp16), 2)}[case]
    with pytest.raises(bad[0]):
        stack.mma_layer(bad[1], bad[2], bad[3])


def test_probe_rehearsal_on_cpu(capsys):
    assert mma_probe.main(["--device", "cpu", "--rows", "256", "--products",
                           "2", "--iters", "1"]) == 0
    assert "no device time" in capsys.readouterr().out


def test_mid_mma_changes_no_cpu_result(sp16, sp32, rng, monkeypatch):
    ylow = torch.from_numpy(rng.random((1, 7, 9), dtype=np.float32))
    uvp = torch.from_numpy(rng.random((1, 7, 9, 8), dtype=np.float32))
    outs = {}
    for flag in (True, False):
        monkeypatch.setattr(stack, "MID_MMA", flag)
        stack.reset_launches()
        y16 = ylow.to(torch.bfloat16)
        outs[flag] = (stack.stack_scale(y16, sp16),
                      stack.stack_scale(ylow, sp32),
                      stack.stack_noise(y16, sp16),
                      stack.stack_scale_fused_u8(y16, uvp, sp16),
                      stack.stack_scale_upto(y16, sp16, 4))
        assert stack.LAUNCHES == 0
        assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                      "mma_zs": 0, "mma_pp": 0,
                                      "mma_tf32": 0}
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)


class _FakeLib:
    """Stands in for a ctypes library: records every C entry called with
    its arguments and reports success."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def _fake_launcher(calls, bf16: bool):
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "scale", None, 0
    run.libs = {name: _FakeLib(calls)
                for name in ("stack", "mma", "l6", "l7", "l1", "mma_tf32")}
    run.bf16, run.stream = int(bf16), 0
    return run


@pytest.mark.parametrize("bf16,mid_mma,want", [
    (True, True, {"mma": 5, "ffma": 0, "mma_tf32": 0}),
    (True, False, {"mma": 0, "ffma": 5, "mma_tf32": 0}),
    (False, True, {"mma": 0, "ffma": 0, "mma_tf32": 5}),
    (False, False, {"mma": 0, "ffma": 5, "mma_tf32": 0})])
def test_launch_count_table(sp16, sp32, monkeypatch, bf16, mid_mma, want):
    """Which C entry each of a whole stack's 7 layers goes to, by storage
    dtype and MID_MMA, with the arguments the tensor-core entries get:
    layer 1 on csrc/l1.cu and layer 7 folded on csrc/l7.cu (bf16 on the
    tensor cores, f32 with FFMA) whatever MID_MMA says; layers 2-6 of an
    f32 stack as 3xTF32 while MID_MMA is on."""
    monkeypatch.setattr(stack, "MID_MMA", mid_mma)
    stack.reset_launches()
    sp = sp16 if bf16 else sp32
    calls = []
    run = _fake_launcher(calls, bf16)
    x = torch.zeros(1, dtype=sp[0][0].dtype)
    n, ph, pw = 2, 10, 12
    for k in range(7):
        run.layer(k, False, x, sp, x, n, ph, pw)
    assert stack.LAUNCHES == stack.KERNEL_LAUNCHES["scale"] == 7
    assert stack.L6_LAUNCHES["direct"] == 1
    assert stack.MID_LAUNCHES == {**want, "chain": 0, "mma_zs": 0,
                                  "mma_pp": 0}
    assert stack.L1_LAUNCHES == {"l1": 1, "ffma": 0}
    assert [fn for fn, _ in calls] == [
        "w2x_l1" if k == 0
        else "w2x_mma_layer" if want["mma"] and 1 <= k <= 5
        else "w2x_tf32_layer" if want["mma_tf32"] and 1 <= k <= 5
        else "w2x_l7_fold" if k == 6 else "w2x_stack_layer"
        for k in range(7)]
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16),
                                 "cell": 0, "pixel": 0}
    stack.reset_launches()
    assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                  "mma_zs": 0, "mma_pp": 0,
                                      "mma_tf32": 0}
    if want["mma_tf32"]:
        for k, (_, args) in list(enumerate(calls))[1:6]:
            # (bf16, layer, x, whi, wlo, b, y, n, hin, win, smem, stream)
            assert args[:2] == (0, k)
            assert args[3:5] == tuple(t.data_ptr() for t in sp.wt[k - 1])
            assert args[5] == sp[k][1].data_ptr()
            assert args[7:] == (n, 2 * ph + 14 - 2 * k, 2 * pw + 14 - 2 * k,
                                stack.tf32_plan(*stack.WIDTHS[k]).smem_bytes,
                                0)
    if not want["mma"]:
        return
    for k, (_, args) in list(enumerate(calls))[1:6]:
        plan = stack.mma_plan(*stack.WIDTHS[k])
        # (bf16, layer, x, wp, b, y, n, hin, win, smem_bytes, stream)
        assert args[:2] == (1, k) and args[3] == sp.wm[k - 1].data_ptr()
        assert args[4] == sp[k][1].data_ptr()
        assert args[6:] == (n, 2 * ph + 14 - 2 * k, 2 * pw + 14 - 2 * k,
                            plan.smem_bytes, 0)


class _FailingLib:
    """A ctypes library whose every entry reports a launch error."""

    def __getattr__(self, fn):
        if fn == "w2x_error_string":
            return lambda err: b"invalid argument"
        return lambda *args: 1


@pytest.mark.parametrize("k", MID)
def test_failed_launch_counts_nowhere(sp16, sp32, monkeypatch, k):
    """A launch counts after its error code is read: one that is refused
    raises and leaves every count as it was, for either mid-layer kernel."""
    x = torch.zeros(1, dtype=torch.bfloat16)
    for bf16, sp in ((True, sp16), (False, sp32)):
        monkeypatch.setattr(stack, "MID_MMA", True)
        stack.reset_launches()
        run = _fake_launcher([], bf16)
        run.libs = {name: _FailingLib()
                    for name in ("stack", "mma", "l6", "mma_tf32")}
        with pytest.raises(RuntimeError, match="invalid argument"):
            run.layer(k - 1, False, x, sp, x, 1, 10, 12)
        assert stack.LAUNCHES == 0 and not any(stack.L6_LAUNCHES.values())
        assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                      "mma_zs": 0, "mma_pp": 0,
                                      "mma_tf32": 0}


def test_mma_layer_alone_counts_as_no_stack_launch(sp16):
    """mma_layer's own launcher has no wrapper kind: its launch shows under
    MID_LAUNCHES["mma"] and in no count that whole stacks add to."""
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls, True)
    run.kind = None
    x = torch.zeros(1, dtype=torch.bfloat16)
    run.mma_layer(3, x, sp16, x, 1, 20, 24)
    assert [fn for fn, _ in calls] == ["w2x_mma_layer"]
    assert stack.MID_LAUNCHES == {"mma": 1, "ffma": 0, "chain": 0,
                                  "mma_zs": 0, "mma_pp": 0,
                                      "mma_tf32": 0}
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())
    assert not any(stack.L6_LAUNCHES.values())
    stack.reset_launches()


def test_noise_stack_layer_planes_round_odd_sizes_up(sp16, monkeypatch):
    """The noise stack runs on the plane rounded up to even: the tensor-core
    entry gets that plane's layer sizes."""
    monkeypatch.setattr(stack, "MID_MMA", True)
    calls = []
    run = _fake_launcher(calls, True)
    x = torch.zeros(1, dtype=torch.bfloat16)
    run.layer(3, True, x, sp16, x, 1, 27, 38)
    assert calls[0][1][6:9] == (1, 28 + 14 - 6, 38 + 14 - 6)
    stack.reset_launches()
