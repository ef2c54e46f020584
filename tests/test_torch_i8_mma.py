"""The int8 layer 6 (B4) on the int8 tensor cores (csrc/i8.cu, wgmma
s8 x s8 -> s32) on the CPU: its weight packer (ops/s2d.py:pack_mma_i8,
StackParams.w6i) against w6q and the JAX package's quantised weights; a
CPU emulation of the kernel's walk (16 x 16 units of one tile, the window
quantised into the [k16][row][col][16] layout with the kernel's stride,
each tap's operands gathered through the descriptors' strides, the
epilogue's f32 steps) against l6_i8_layer_plain, bit for bit; the
kernel's geometry, read from its source; and which C entry each int8 call
reaches (a fake library stands in for the card). The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py (phase 14a), bit for bit."""

import contextlib
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as jps
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import s2d, stack
from waifu2x_torch.ops.convstack import leaky_relu

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sps(params_np):
    return {dt: stack.prep_params(params_from_numpy(params_np), dt, "cpu")
            for dt in (torch.float32, torch.bfloat16)}


# --- the weights -------------------------------------------------------------

def test_w6i_round_trips_to_w6q(sps):
    """w6i is pack_mma_i8 of w6q's int8 values: [ci/16, 9, co, 16] with
    w6i[c16, t, o, k] = q[16 c16 + k, t, o]; unpack_mma inverts it; bf16 and
    f32 weights carry the same one."""
    sp = sps[torch.float32]
    q = stack.unpack_w6q(sp.w6q)                          # [ci, tap, co]
    w6i = sp.w6i
    assert w6i.shape == (8, 9, 128, 16) and w6i.dtype == torch.int8
    assert w6i.is_contiguous()
    assert torch.equal(w6i, s2d.pack_mma_i8(q))
    assert torch.equal(s2d.unpack_mma(w6i).permute(1, 0, 2), q)
    rng = np.random.default_rng(0)
    for c16, t, o, k in rng.integers(0, (8, 9, 128, 16), size=(64, 4)):
        assert w6i[c16, t, o, k] == q[16 * c16 + k, t, o]
    assert torch.equal(sps[torch.bfloat16].w6i, w6i)
    with pytest.raises(ValueError, match="int8"):
        s2d.pack_mma_i8(q.float())
    with pytest.raises(ValueError, match="multiple of 16"):
        s2d.pack_mma_i8(q[:8])


def test_w6i_matches_the_jax_quantised_weights(params_np, sps):
    """The packed weights hold the JAX package's int8 weights
    (pack_for_kernels: each of its four phase packs holds all 9 taps, found
    by packing a tensor of row indices the same way)."""
    arrays, _ = jps.pack_for_kernels(params_np, True)
    w6i = sps[torch.float32].w6i
    q = w6i.permute(0, 3, 1, 2).reshape(128, 9, 128).numpy()   # [ci, tap, co]
    index = np.broadcast_to(
        np.arange(9 * 128, dtype=np.float32).reshape(3, 3, 128, 1),
        (3, 3, 128, 128))                                    # tap * 128 + ci
    rows, _ = jps.pack_mid_kernel(index)
    for p in range(4):
        tap, ci = np.divmod(rows[p, :, 0].astype(int), 128)
        np.testing.assert_array_equal(q[ci, tap], arrays["w6q"][p])
        np.testing.assert_array_equal(sps[torch.float32].w6s.numpy(),
                                      arrays["w6s"][p])


# --- the kernel's geometry, read from its source -----------------------------

def _source():
    return (ROOT / "waifu2x_torch" / "csrc" / "i8.cu").read_text()


def _geometry() -> dict:
    """csrc/i8.cu's unit, threads, window k16 stride (16-byte units) and
    dynamic shared memory, from its constants and the formulas it states."""
    src = _source()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (Q\w+) = (\d+);", src)}
    assert "QWIN = QT + 2;" in src and "QS = QWIN * QWIN + 1;" in src
    assert "Q_SMEM = Q_W_BYTES + 2 * Q_WIN_BYTES + Q_C * 8;" in src
    qt = consts["QT"]
    stride = (qt + 2) ** 2 + 1
    smem = 8 * 9 * 128 * 16 + 2 * 8 * stride * 16 + 128 * 8
    return {"tile": qt, "threads": consts["Q_THREADS"], "stride": stride,
            "smem": smem}


# --- the kernel's walk, emulated ---------------------------------------------

def _emulate(x5: torch.Tensor, sp, tile) -> tuple:
    """csrc/i8.cu's function on the CPU, step by step: per tile the scale
    from max |x5| over its window; per 16 x 16 unit the 18 x 18 window
    quantised into a flat int8 buffer laid out [k16][pixel][16] with
    the kernel's k16 stride, zero outside the tile's window; per warpgroup
    quarter the A operand of all 9 taps and 4 k32 steps gathered from that
    buffer through the descriptor strides (LBO the k16 stride, SBO a window
    row), B from w6i through its own (LBO 9 x 128 x 16, SBO 128), the int32
    sums exact (f64); the epilogue float(sum) * (sx * sw) + b, LeakyReLU,
    the storage rounding; outputs past the tile masked."""
    tr, tc = tile
    n, h5, w5, _ = x5.shape
    ny, nx = (h5 - 4) // (2 * tr), (w5 - 4) // (2 * tc)
    hout, wout = 2 * tr + 2, 2 * tc + 2
    geo = _geometry()
    qt, win, stride = geo["tile"], geo["tile"] + 2, geo["stride"]
    nty, ntx = -(-hout // qt), -(-wout // qt)   # the unit grid of a tile
    # B: byte (kk, co) of the 9 taps' operands at c16 * LBO + tap * 2048 +
    # co * 16 + k (SBO 128 = 8 output channels of 16 bytes)
    flat_w = sp.w6i.flatten().double()
    kk = torch.arange(128)
    co = torch.arange(128)
    b_all = torch.cat([
        flat_w[((kk // 16) * 9 * 2048 + tap * 2048 + kk % 16)[:, None]
               + co[None, :] * 16] for tap in range(9)])      # [1152, 128]
    # A: byte (m, kk) of tap (dy, dx) of quarter (ty8, tx8)
    m = torch.arange(64)
    a_idx = {}
    for q8 in range(4):
        a_off = (8 * (q8 >> 1) * win + 8 * (q8 & 1)) * 16
        a_idx[q8] = torch.cat([
            ((kk // 16) * stride * 16 + kk % 16)[None, :] + a_off
            + ((tap // 3) * win + tap % 3) * 16
            + ((m // 8) * win * 16 + (m % 8) * 16)[:, None]
            for tap in range(9)], dim=1)                     # [64, 1152]
    sw, b6 = sp.w6s, sp[5][1]
    x6 = torch.zeros((n, ny, nx, hout, wout, 128), dtype=x5.dtype)
    sx_all = torch.zeros((n, ny, nx))
    for i in range(n):
        for ti in range(ny):
            for tj in range(nx):
                xw = x5[i, 2 * ti * tr:2 * ti * tr + hout + 2,
                        2 * tj * tc:2 * tj * tc + wout + 2].float()
                sx = torch.clamp(xw.abs().max(), min=1e-8) * stack._INV127
                sx_all[i, ti, tj] = sx
                inv = torch.ones(()) / sx
                qx = torch.clamp(torch.round(xw * inv), -127, 127)
                for uy in range(nty):
                    for ux in range(ntx):
                        oy0, ox0 = qt * uy, qt * ux
                        window = torch.zeros((win, win, 128))
                        part = qx[oy0:oy0 + win, ox0:ox0 + win]
                        window[:part.shape[0], :part.shape[1]] = part
                        buf = torch.zeros((8, stride, 16))
                        buf[:, :win * win] = (window.reshape(win * win, 8, 16)
                                              .permute(1, 0, 2))
                        buf = buf.flatten().double()
                        for q8 in range(4):
                            acc = buf[a_idx[q8]] @ b_all          # [64, 128]
                            y = leaky_relu(acc.float() * (sx * sw) + b6)
                            py = oy0 + 8 * (q8 >> 1) + torch.arange(8)
                            px = ox0 + 8 * (q8 & 1) + torch.arange(8)
                            y = y.reshape(8, 8, 128)
                            ry, rx = py < hout, px < wout
                            x6[i, ti, tj, py[ry][:, None], px[rx][None, :]] = (
                                y[ry][:, rx].to(x5.dtype))
    return x6, sx_all


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tile,grid", [((8, 16), (2, 2)), ((64, 128), (1, 1)),
                                       ((5, 13), (2, 3))],
                         ids=["8x16", "64x128", "ragged-5x13"])
def test_emulated_walk_is_the_plain_layer_bit_for_bit(sps, dtype, tile,
                                                      grid):
    """The kernel's walk, emulated, equals l6_i8_layer_plain bit for bit:
    the int32 sums are exact whatever the order, and the units cover every
    output of a tile (a 64 x 128 tile's 130 x 258 outputs: 9 x 17 units,
    the last row and column of units masked past the tile; a 5 x 13 tile's
    12 x 28 outputs: 1 x 2)."""
    sp = sps[dtype]
    (tr, tc), (ny, nx) = tile, grid
    x5 = torch.from_numpy(np.random.default_rng(sum(tile)).standard_normal(
        (1, 2 * ny * tr + 4, 2 * nx * tc + 4, 128)).astype(np.float32))
    x5 = x5.to(dtype)
    got, sx = _emulate(x5, sp, tile)
    want, sx_want = stack.l6_i8_layer_plain(x5, sp, tile)
    assert want.dtype == got.dtype == dtype
    assert torch.equal(sx, sx_want)
    assert torch.equal(got, want)
    assert torch.equal(stack.l6_i8_layer(x5, sp, tile)[0], want)


# --- the geometry and the C entry -------------------------------------------

def test_i8_geometry_fits_a_block():
    """csrc/i8.cu's geometry: a 16 x 16 unit, four warpgroups (one 8 x 8
    m64 quarter each), the resident weights, two windows and the
    channels' (sw, b) pairs within the 227 KB a block may use (the source
    asserts the same); the stride is odd (the staging's 8-byte stores of
    one pixel's 8 k16 groups fall into 16 banks)."""
    geo = _geometry()
    assert geo["tile"] == 16 and geo["threads"] == 4 * 128
    assert geo["stride"] % 2 == 1
    assert geo["smem"] <= stack.SMEM_MAX
    assert "static_assert(Q_SMEM <= 232448" in _source()
    assert "m64n128k32.s32.s8.s8" in (
        ROOT / "waifu2x_torch" / "csrc" / "mma.cuh").read_text()


class _FakeLib:
    """Stands in for a ctypes library: records every C entry called."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
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


@pytest.mark.parametrize("kind,shape", [("scale", (1, 20, 36)),
                                        ("noise", (1, 27, 38))],
                         ids=["scale", "noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_i8_stack_dispatch(sps, fake_card, kind, shape, dtype):
    """A stack call under l6_i8 (the scale stack on a whole tile grid, the
    noise stack on an odd full-res plane): layer 5 takes the tile maxima in
    its epilogue (csrc/mma.cu in bf16, csrc/mma_tf32.cu in f32) into the m
    that the layer on the int8 tensor cores (csrc/i8.cu, with w6i) reads, 7
    launches in all. L6_LAUNCHES["i8"] counts layer 6's launch, I8_LAUNCHES
    the layer's and the maxima's."""
    sp = sps[dtype]
    x = torch.zeros(shape, dtype=dtype)
    stack._launch(x, sp, kind, None, form="i8", tile=(8, 16))
    names = [fn for fn, _ in fake_card]
    l5 = ("w2x_mma_layer_max" if dtype == torch.bfloat16
          else "w2x_tf32_layer_max")
    assert names[4:6] == [l5, "w2x_l6_i8_mma"]
    assert len(names) == 7 == stack.LAUNCHES
    assert stack.L6_LAUNCHES["i8"] == 1
    assert stack.I8_LAUNCHES == {"mma": 1, "l5max": 1}
    # (bf16, x5, w, sw, b, m, x6, n, tr, tc, ny, nx, stream)
    args = fake_card[5][1]
    assert len(args) == 13
    assert args[0] == int(dtype == torch.bfloat16)
    assert args[2] == sp.w6i.data_ptr()
    hl, wl = shape[1:] if kind == "scale" else (14, 19)
    ny, nx = -(-hl // 8), -(-wl // 16)
    assert args[7:12] == (1, 8, 16, ny, nx)
    # the layer reads the m that the maxima were written into
    maxima = fake_card[4][1]
    assert args[5] == maxima[-6]
    assert maxima[-5:-1] == (8, 16, ny, nx)


def test_i8_layer_alone_counts_no_stack(sps, fake_card):
    """The int8 layer alone, as l6_i8_layer launches it on the card, from
    layer 5's maxima m: one launch, the layer's, under I8_LAUNCHES["mma"],
    no stack count."""
    sp = sps[torch.float32]
    x5 = torch.zeros((1, 2 * 8 + 4, 2 * 16 + 4, 128))
    tiling = stack._check_x5(x5, sp, (8, 16))
    m = torch.zeros((1, 1, 1))
    stack._Launcher(None, x5, None).l6_i8(x5, sp, 1, tiling, m)
    assert [fn for fn, _ in fake_card] == ["w2x_l6_i8_mma"]
    assert fake_card[-1][1][5] == m.data_ptr()
    assert stack.I8_LAUNCHES == {"mma": 1, "l5max": 0}
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())


def test_i8_layer_needs_w6i(sps, fake_card):
    sp = stack.StackParams(list(sps[torch.float32]))
    for name in ("w6q", "w6s"):
        setattr(sp, name, getattr(sps[torch.float32], name))
    x5 = torch.zeros((1, 20, 36, 128))
    with pytest.raises(ValueError, match="w6i"):
        stack.l6_i8_layer(x5, sp, (8, 16))
    assert not fake_card
