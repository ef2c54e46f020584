"""The truncation's two tap forms (stack_scale_upto at upto 6, out="cell"
and "phase_taps") as output forms of layer 7's fold (csrc/l7.cu) on the
CPU: the fold's tap partials (l7_fold_plain(taps=True), l7_tiles_plain on
the int8 layer's tile-major planes) against the same partials summed tap
by tap (_taps_plain, _phase_taps_plain) on planes, on tiles and at odd
shapes; the
phase taps' packed weight (ops/s2d.py:pack_l7_ptaps) and the read of pixel
(0, 0) alone that it allows; the launcher's tap launch (_Launcher.taps,
which stack_scale_upto's upto 6 and chip_smoke.py call) and which C entry
each stack_scale_upto call reaches, with its counts (a fake library stands
in for the card). Bars: f32 3e-5 (two orders of f32
sums), bf16 one ulp of the rounded value. The JAX kernel against
stack_scale_upto is tests/test_torch_trunc.py's; the CUDA kernels against
these plain versions are chip_smoke.py's (phase 19)."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import pack_l7_fold, pack_l7_ptaps

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]
F32_TOL = 3e-5
SUM_SPREAD = 1e-5   # what two f32 orders of sums differ by at order 1
# planes (N, hl, wl): a small one, an odd one, a thin one
PLANES = [(1, 27, 38), (2, 37, 53), (1, 5, 300)]
FORMS = ["cell", "phase_taps"]   # stack_scale_upto's names at upto 6
TAPS = {"cell": stack._taps_plain, "phase_taps": stack._phase_taps_plain}


@pytest.fixture(scope="module")
def sps():
    return {dt: stack.prep_params(init_params(3), dt, "cpu") for dt in DTYPES}


def _x6(shape, dtype, seed, lead=()):
    n, hl, wl = shape
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, *lead, 2 * hl + 2, 2 * wl + 2, 128),
                       generator=gen) * 2 - 1).to(dtype)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 at |v|."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _hold(got: torch.Tensor, ref: torch.Tensor, dtype) -> None:
    """f32 within 3e-5; bf16 (both rounded once from f32 sums of the same
    products in two orders) within one bf16 ulp at the larger magnitude, or
    SUM_SPREAD where the terms cancel to less (chip_smoke.py's bar for the
    tensor-core layers)."""
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= F32_TOL
    else:
        g, r = got.to(dtype).float(), ref.to(dtype).float()
        tol = _ulp(torch.maximum(g.abs(), r.abs())).clamp_min(SUM_SPREAD)
        assert bool(((g - r).abs() <= tol).all())


def _w7(sp) -> np.ndarray:
    """The stored w7 [128, 9, 1] as [3, 3, 128, 1] f32."""
    return (sp[6][0].float().reshape(128, 3, 3, 1).permute(1, 2, 0, 3)
            .numpy())


# --- the phase taps' weight -------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_pack_l7_ptaps(sps, dtype):
    """W [512, 16]: rows 0-127 (pixel (0, 0)'s inputs, pack_l7_fold's lane
    order) hold w7's taps 0-3 in lanes 0-3, every other entry zero;
    prep_params keeps it as StackParams.w7p in the storage type, equal to
    the stored w7's values."""
    sp = sps[dtype]
    w7 = _w7(sp)
    w = pack_l7_ptaps(w7)
    assert w.shape == (512, 16) and w.dtype == np.float32
    for t in range(4):
        np.testing.assert_array_equal(w[:128, t], w7[t // 3, t % 3, :, 0])
    assert not w[128:].any() and not w[:, 4:].any()
    assert sp.w7p.dtype == dtype and sp.w7p.shape == (512, 16)
    assert torch.equal(sp.w7p.float(), torch.from_numpy(w))
    assert stack._w7f(sp, sp[6][0], True) is sp.w7p
    # the same-cell taps are lanes 0-3 of the fold's own weight
    fold = pack_l7_fold(w7)
    for q in range(4):
        a, b = q // 2, q % 2
        for p in range(4):
            pa, pb = p // 2, p % 2
            dy, dx = pa - a, pb - b
            want = (w7[dy, dx, :, 0] if dy >= 0 and dx >= 0
                    else np.zeros(128, np.float32))
            np.testing.assert_array_equal(fold[p * 128:(p + 1) * 128, q],
                                          want)
    with pytest.raises(ValueError, match="pack_l7_ptaps"):
        pack_l7_ptaps(np.zeros((3, 3, 128)))


def test_f32_params_pack_w7p_themselves(sps):
    """A bare tuple of f32 (w, b) pairs gets w7p packed from its w7; bf16
    ones need prep_params'."""
    sp = sps[torch.float32]
    bare = stack.StackParams(list(sp))
    assert torch.equal(stack._w7f(bare, sp[6][0], True), sp.w7p)
    with pytest.raises(ValueError, match="w7p"):
        stack._w7f(stack.StackParams(list(sps[torch.bfloat16])),
                   sps[torch.bfloat16][6][0], True)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_phase_taps_read_pixel_00_alone(sps, dtype):
    """Only pixel (0, 0) of each cell enters the phase taps (w7p's other
    rows are zero): the kernel reads that pixel's boxes alone, and any
    values at the other three pixels leave the output unchanged, bit for
    bit."""
    sp = sps[dtype]
    x6 = _x6((1, 9, 14), dtype, 5)
    ref = stack.l7_fold_plain(x6, sp.w7p, None, taps=True)
    other = x6.clone()
    mask = torch.ones(other.shape[1:3], dtype=torch.bool)
    mask[0::2, 0::2] = False
    other[:, mask] = torch.rand(other[:, mask].shape).to(dtype) * 100
    assert torch.equal(stack.l7_fold_plain(other, sp.w7p, None, taps=True),
                       ref)
    assert not torch.equal(
        stack.l7_fold_plain(other, sp.w7f, None, taps=True),
        stack.l7_fold_plain(x6, sp.w7f, None, taps=True))


# --- the fold's tap forms against the tap-by-tap sums ------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", PLANES, ids=["27x38", "37x53", "5x300"])
@pytest.mark.parametrize("out", FORMS)
def test_fold_taps_on_planes(sps, dtype, shape, out):
    """l7_fold_plain(taps=True): Zt's lanes 0-3 of each cell, from w7f (the
    same-cell taps) or w7p (the phase taps), equal the tap-by-tap sums (the
    4 taps that lie in the cell, or pixel (0, 0) through taps 0-3) to the
    bars; no bias and no LeakyReLU."""
    sp = sps[dtype]
    x6 = _x6(shape, dtype, 7)
    got = stack.l7_fold_plain(x6, stack._w7f(sp, x6, out == "phase_taps"),
                              None, taps=True)
    ref = TAPS[out](x6.permute(0, 3, 1, 2).float(), sp[6][0], torch.float32)
    assert got.shape == ref.shape == (*shape, 4)
    _hold(got, ref, dtype)
    # the plain version of the kernel, as the stack's takes it
    assert torch.equal(stack._last_taps_plain(x6, sp, out), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape,tile", [((1, 32, 32), (8, 16)),
                                        ((2, 27, 38), (8, 16)),
                                        ((1, 5, 300), (3, 5))],
                         ids=["32x32", "27x38", "5x300"])
@pytest.mark.parametrize("out", FORMS)
def test_fold_taps_on_tiles(sps, dtype, shape, tile, out):
    """On B4's tile-major planes: l7_tiles_plain(taps=True), each tile's
    partials at the image's cells, cropped, against the tap-by-tap sums tile
    by tile, to the bars; each tile's _last_taps_plain placed at its cells
    is the same."""
    sp = sps[dtype]
    n, hl, wl = shape
    tr, tc = tile
    ny, nx = -(-hl // tr), -(-wl // tc)
    x6t = _x6((n, tr, tc), dtype, 9, lead=(ny, nx))
    got = stack.l7_tiles_plain(x6t, stack._w7f(sp, x6t, out == "phase_taps"),
                               None, taps=True)[:, :hl, :wl]
    planes = x6t.reshape(-1, *x6t.shape[3:]).permute(0, 3, 1, 2).float()
    ref = stack._tiles_image(TAPS[out](planes, sp[6][0], torch.float32), n,
                             ny, nx)[:, :hl, :wl]
    _hold(got, ref, dtype)
    planes = x6t.reshape(-1, *x6t.shape[3:])
    assert torch.equal(stack._tiles_image(stack._last_taps_plain(
        planes, sp, out), n, ny, nx)[:, :hl, :wl], got)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("l6", ["direct", "i8", "wino"])
@pytest.mark.parametrize("out", ["cell", "phase_taps"])
def test_stack_scale_upto_folds_the_taps(sps, monkeypatch, dtype, l6, out):
    """stack_scale_upto at upto 6 on the CPU takes the plain version of the
    kernel: the fold's tap form; the same stack ending in the tap-by-tap
    sums shares layers 1-6, so the two differ by layer 7's order of sums
    alone, within the bars."""
    sp = sps[dtype]
    y = torch.rand((1, 11, 19), generator=torch.Generator().manual_seed(3)
                   ).to(dtype)
    kw = {"l6_i8": l6 == "i8", "l6_wino": l6 == "wino"}
    if l6 == "i8":
        kw["tile"] = (4, 8)
    got = stack.stack_scale_upto(y, sp, 6, out=out, **kw)
    assert torch.equal(
        got, stack.stack_scale_upto_plain(y, sp, 6, out=out, **kw))

    def tap_by_tap(x, sp, out):
        return TAPS[out](x.permute(0, 3, 1, 2).float(), sp[6][0],
                         torch.float32)
    monkeypatch.setattr(stack, "_last_taps_plain", tap_by_tap)
    cell = stack.stack_scale_upto(y, sp, 6, out=out, **kw)
    assert got.shape == cell.shape == (1, 11, 19, 4) and got.dtype == dtype
    _hold(got.float(), cell.float(), dtype)


# --- the dispatch ---------------------------------------------------------

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


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("form", ["direct", "i8"])
@pytest.mark.parametrize("out", ["cell", "phase_taps"])
def test_upto6_reaches_the_fold(sps, fake_card, dtype, form, out):
    """stack_scale_upto's last launch at upto 6: w2x_l7_fold in the tap
    form (3 OUT_TAPS, 4 OUT_PTAPS), bf16 from w7f / w7p, f32 from w7 itself,
    on a plane or with the int8 layer's tiling; counted under L7_LAUNCHES
    "fold" / "fold_f32" and L6_LAUNCHES["upto"]."""
    sp = sps[dtype]
    stack._launch(torch.zeros((1, 20, 36), dtype=dtype), sp, "scale", None,
                  form=form, tile=(4, 16) if form == "i8" else None, upto=6,
                  out_form=out)
    fn, args = fake_card[-1]
    bf16 = dtype == torch.bfloat16
    assert fn == "w2x_l7_fold"
    # (bf16, x6, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
    #  tr, tc, ny, nx, zs, stream)
    want_w = ((sp.w7p if out == "phase_taps" else sp.w7f) if bf16
              else sp[6][0])
    assert args[0] == int(bf16) and args[2] == want_w.data_ptr()
    assert args[5:9] == (1, 20, 36, 4 if out == "phase_taps" else 3)
    assert args[12:17] == ((4, 16, 5, 3, 0) if form == "i8"
                           else (0, 0, 0, 0, 0))
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16)}
    assert stack.TAP_LAUNCHES == {"taps": int(out == "cell"),
                                  "ptaps": int(out == "phase_taps")}
    assert stack.L6_LAUNCHES["upto"] == 1
    assert stack.LAUNCHES == 7   # under i8, layer 5 takes the tile maxima


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("tiled", [False, True], ids=["plane", "tiles"])
@pytest.mark.parametrize("out", FORMS)
def test_fold_launch_takes_the_forms_weight(sps, fake_card, dtype, tiled,
                                            out):
    """The launcher's tap launch (_Launcher.taps, layer 7 alone in a tap
    form, as stack_scale_upto and chip_smoke.py reach it): the fold in
    out_mode 3 or 4, bf16 from w7f or w7p, f32 from w7 itself, on a plane
    or with a tiling, counted under L7_LAUNCHES and TAP_LAUNCHES by form;
    the fold takes no zero-shift mask with a tap form."""
    sp = sps[dtype]
    x6 = torch.zeros((1, 10, 14, 128), dtype=dtype)
    tiling = (4, 6, 1, 1) if tiled else None
    mode = stack._OUT_PTAPS if out == "phase_taps" else stack._OUT_TAPS
    run = stack._Launcher(None, x6, None)
    run.taps(x6, sp, torch.empty(1), 1, 4, 6, out, tiling)
    fn, args = fake_card[-1]
    bf16 = dtype == torch.bfloat16
    want = ((sp.w7p if out == "phase_taps" else sp.w7f) if bf16
            else sp[6][0])
    assert fn == "w2x_l7_fold" and args[8] == mode
    assert args[2] == want.data_ptr()
    assert args[12:17] == ((4, 6, 1, 1, 0) if tiled else (0, 0, 0, 0, 0))
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16)}
    tap = "ptaps" if out == "phase_taps" else "taps"
    assert stack.TAP_LAUNCHES == {k: int(k == tap) for k in
                                  stack.TAP_LAUNCHES}
    assert stack.LAUNCHES == 0 and stack.L6_LAUNCHES["upto"] == 0
    with pytest.raises(ValueError, match="zero-shift"):
        run.l7_fold(x6, sp, torch.empty(1), 1, 4, 6, mode, zs=1)
