"""B7's gather and B4's tile maxima in layer 5's epilogue, on the CPU.

csrc/gather.cu:upto_gather_tiled (stack_scale_upto at upto 0..5): an emulation
of its walk (bands of rows, a warp a row, the 16-byte vectors of a row
segment and the elements before and after them, the low-res band staged
with its clamped halo) writes every element of the output once and equals
stack_scale_upto_plain bit for bit at the shapes where the walk is most
likely to slip (odd widths, tail cells, planes under 4 cells), in both
storage types, at every upto and output form.

Layer 5's tile-maxima epilogue (csrc/mma.cu, csrc/mma_tf32.cu, through
common.cuh:tile_max_block): an emulation of the epilogue (the accumulator
fragment's pixels and channels, the four lanes of a pixel, each 16 x 16
block's share of every tile window it meets) gives tile_max_plain's
maxima, bit for bit, at the default tile and at small tiles where a block
meets many windows, with NaN dropped as fmaxf drops it. The B4 stack's
plain version is held against the JAX kernel in interpret mode.

Which C entry each call reaches is held with a fake library standing in for
the card; each C entry's parameter count against the ctypes table. The CUDA
kernels themselves are held bit for bit against the plain versions on the
card by chip_smoke.py (phase 32)."""

import contextlib
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
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import stack

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "waifu2x_torch" / "csrc"
DTYPES = (torch.float32, torch.bfloat16)
DT_IDS = ("f32", "bf16")
# the shapes the gather's walk is held at: odd widths (wl * 4 * 2 bytes no
# multiple of 16), two images, a wide plane of 5 rows, a plane under 4 cells
GATHER_SHAPES = ((1, 27, 38), (2, 37, 53), (1, 5, 300), (1, 3, 2))
# (upto, output form) of every gather launch
GATHER_FORMS = ([(k, "cell") for k in range(6)]
                + [(0, "lane0"), (0, "whole")])


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sps(params_np):
    return {dt: stack.prep_params(params_from_numpy(params_np), dt, "cpu")
            for dt in DTYPES}


def _const(src: str, name: str) -> int:
    """A constexpr int of the source, or the default of the macro it is."""
    m = re.search(rf"constexpr int {name} = (\w+);", src).group(1)
    if m.isdigit():
        return int(m)
    return int(re.search(rf"#define {m} (\d+)", src).group(1))


@pytest.fixture(scope="module")
def geometry():
    src = (CSRC / "gather.cu").read_text()
    return {k: _const(src, k) for k in ("GT_ROWS", "GT_COLS", "GT_UNROLL")}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as their storage bits (the gather moves bits)."""
    return (t.contiguous().view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16
            else t.contiguous().numpy().view(np.uint32))


# --- the gather --------------------------------------------------------------

def emulate_gather(x: np.ndarray, mode: int, n: int, hl: int, wl: int,
                   geo: dict):
    """upto_gather_tiled's walk on storage bits: x is the activation
    [n, H, W, C] (mode 0) or the low-res plane [n, hl, wl] -> (y flat, the
    number of times each element was written)."""
    rows, cols, unroll = geo["GT_ROWS"], geo["GT_COLS"], geo["GT_UNROLL"]
    vlen = 16 // x.itemsize
    pad = 8 if mode == 3 else 0
    oh, ow, epc = hl + pad, wl + pad, 1 if mode == 3 else 4
    y = np.zeros(n * oh * ow * epc, x.dtype)
    writes = np.zeros(y.size, np.int32)
    nbr, nbc = -(-oh // rows), -(-ow // cols)
    for band in range(n * nbr * nbc):          # any order: no band reads y
        bc, rest = band % nbc, band // nbc
        br, img = rest % nbr, rest // nbr
        i0, j0 = br * rows, bc * cols
        if mode != 0:   # the staged band, each index clamped into the plane
            sy = np.clip(i0 + np.arange(rows + 1) - 4, 0, hl - 1)
            sx = np.clip(j0 + np.arange(cols + 2) - 4, 0, wl - 1)
            s = x[img][sy][:, sx]
        for warp in range(rows):
            i = i0 + warp
            if i >= oh:
                continue

            def cell(j, t):
                if mode == 0:
                    return x[img, 2 * i, 2 * j, t]
                if mode == 2:
                    return s[warp, j - j0]
                return s[warp + 1, j - j0] if t == 3 else s[warp, j - j0 + t]

            def elem(le):
                return s[warp, le - j0] if mode == 3 else cell(le >> 2, le & 3)

            def vec(le):
                if mode == 0:   # one 8- or 16-byte load a cell, aligned
                    assert le % 4 == 0
                    out = []
                    for c in range(vlen // 4):
                        j = (le >> 2) + c
                        off = ((img * x.shape[1] + 2 * i) * x.shape[2]
                               + 2 * j) * x.shape[3]
                        assert (off * x.itemsize) % (4 * x.itemsize) == 0
                        out += list(x[img, 2 * i, 2 * j, 0:4])
                    return out
                if mode == 3:
                    return [s[warp, le - j0 + q] for q in range(vlen)]
                assert le % 4 == 0
                return [cell((le >> 2) + q // 4, q % 4) for q in range(vlen)]

            base = (img * oh + i) * ow * epc
            e0, e1 = j0 * epc, min(j0 + cols, ow) * epc
            v0, v1 = (base + e0 + vlen - 1) // vlen, (base + e1) // vlen

            def put(e, value):
                y[e] = value
                writes[e] += 1

            if v0 >= v1:
                for lane in range(32):
                    for le in range(e0 + lane, e1, 32):
                        put(base + le, elem(le))
                continue
            a, b = v0 * vlen - base, v1 * vlen - base
            assert a - e0 < 32 and e1 - b < 32
            for lane in range(32):
                if e0 + lane < a:
                    put(base + e0 + lane, elem(e0 + lane))
                if b + lane < e1:
                    put(base + b + lane, elem(b + lane))
                for v in range(v0 + lane, v1, 32 * unroll):
                    built = [(v + 32 * u, vec((v + 32 * u) * vlen - base))
                             for u in range(unroll) if v + 32 * u < v1]
                    for vv, vals in built:
                        for q, value in enumerate(vals):
                            put(vv * vlen + q, value)
    return y, writes


@pytest.mark.parametrize("upto,out", GATHER_FORMS,
                         ids=[f"upto{k}-{o}" for k, o in GATHER_FORMS])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATHER_SHAPES])
def test_gather_walk_equals_plain(sps, geometry, shape, dtype, upto, out):
    """Every element of the gather's output is written once, and the walk's
    values equal stack_scale_upto_plain's bit for bit."""
    rng = np.random.default_rng(sum(shape) + upto)
    ylow = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dtype)
    sp = sps[dtype]
    n, hl, wl = shape
    mode = stack._GATHER_LOWRES[out] if upto == 0 else 0
    src = (ylow if upto == 0 else
           stack.stack_scale_upto_plain(ylow, sp, upto, out="whole"))
    y, writes = emulate_gather(_bits(src), mode, n, hl, wl, geometry)
    assert writes.min() == writes.max() == 1
    ref = stack.stack_scale_upto_plain(ylow, sp, upto, out=out)
    assert np.array_equal(y, _bits(ref).ravel())


@pytest.mark.parametrize("upto,out", GATHER_FORMS,
                         ids=[f"upto{k}-{o}" for k, o in GATHER_FORMS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["tiled", "tiled_f32"])
def test_gather_dispatch(sps, fake_card, dtype, upto, out):
    """stack_scale_upto's last launch at upto 0..5 in either storage type:
    the gather (w2x_upto_gather), with the mode its form takes and the
    layer's plane; counted under GATHER_LAUNCHES and L6_LAUNCHES["upto"]."""
    n, hl, wl = 1, 20, 36
    stack._launch(torch.zeros((n, hl, wl), dtype=dtype), sps[dtype],
                  "scale", None, upto=upto, out_form=out)
    fn, args = fake_card[-1]
    assert fn == "w2x_upto_gather"
    ck = stack.WIDTHS[upto - 1][1] if upto else 1
    # (bf16, x, y, n, hl, wl, H, W, C, mode, stream)
    assert args[0] == int(dtype == torch.bfloat16)
    assert args[3:10] == (n, hl, wl, 2 * hl + 14 - 2 * upto,
                          2 * wl + 14 - 2 * upto, ck,
                          stack._GATHER_LOWRES[out] if upto == 0 else 0)
    assert stack.GATHER_LAUNCHES == {"tiled": 1}
    assert stack.L6_LAUNCHES["upto"] == 1 and stack.LAUNCHES == upto + 1


# --- the tile maxima ---------------------------------------------------------

MT = 16   # the layer-5 kernels' output block


def fragment_pixels():
    """The m64 accumulator fragments of the four warpgroups of a 16 x 16
    block: thread (warpgroup, warp w4, lane) holds pixels (8 ty8 + 2 w4 +
    hh, 8 tx8 + lane/4), hh = 0, 1, and channels 8 j + 2 (lane % 4) +
    {0, 1}, j = 0..15 -> how many threads hold each (row, col, channel)."""
    cover = np.zeros((MT, MT, 128), np.int32)
    for wg in range(4):
        ty8, tx8 = wg >> 1, wg & 1
        for w4 in range(4):
            for lane in range(32):
                for hh in range(2):
                    cover[8 * ty8 + 2 * w4 + hh, 8 * tx8 + (lane >> 2),
                          _LANE_CHANNELS[lane & 3]] += 1
    return cover


# the channels that lane % 4 = q holds of each of its pixels
_LANE_CHANNELS = [(8 * np.arange(16)[:, None] + 2 * q + np.arange(2)).ravel()
                  for q in range(4)]


def emulate_epilogue(pre: np.ndarray, tile, dtype) -> np.ndarray:
    """Layer 5's epilogue with the maxima, from the f32 values it rounds
    to the storage type, pre [n, H5, W5, 128]: each pixel's four lanes take
    fmax of |value| over their channels and meet by xor-shuffles 1 and 2,
    the pixel's max is rounded to the storage type once; then per 16 x 16
    block common.cuh:tile_max_block: a unit is a window the block meets
    and 4 of its rows, a lane a column and every other row of the unit's
    part of the window, fmax, one atomicMax on the float's bits ->
    m [n, ny, nx] f32."""
    n, h5, w5, _ = pre.shape
    tr, tc = tile
    ny, nx = (h5 - 4) // (2 * tr), (w5 - 4) // (2 * tc)
    sy, sx = 2 * tr, 2 * tc
    ab = np.abs(pre)
    px = np.fmax.reduce([np.fmax.reduce(ab[..., ch], axis=-1, initial=0.0)
                         for ch in _LANE_CHANNELS])
    px = torch.from_numpy(px).to(dtype).float().numpy()
    m = np.zeros((n, ny, nx), np.uint32)
    seen = np.zeros((n, ny, nx, 2 * tr + 4, 2 * tc + 4), np.int32)
    for img in range(n):
        for oy0 in range(0, h5, MT):
            for ox0 in range(0, w5, MT):
                y1, x1 = min(oy0 + MT, h5) - 1, min(ox0 + MT, w5) - 1
                ti0, ti1 = max(oy0 - 4, 0) // sy, min(y1 // sy, ny - 1)
                tj0, tj1 = max(ox0 - 4, 0) // sx, min(x1 // sx, nx - 1)
                nj = tj1 - tj0 + 1
                for u in range((ti1 - ti0 + 1) * nj * (MT // 4)):
                    w, g = divmod(u, MT // 4)
                    ti, tj = ti0 + w // nj, tj0 + w % nj
                    r0 = max(oy0 + 4 * g, oy0, ti * sy)
                    r1 = min(oy0 + 4 * g + 3, y1, ti * sy + sy + 3)
                    if r0 > r1:
                        continue
                    c0, c1 = max(ox0, tj * sx), min(x1, tj * sx + sx + 3)
                    best = np.float32(0.0)
                    for lane in range(32):
                        c = ox0 + (lane & 15)
                        if not c0 <= c <= c1:
                            continue
                        for r in range(r0 + (lane >> 4), r1 + 1, 2):
                            best = np.fmax(best, px[img, r, c])
                            seen[img, ti, tj, r - ti * sy, c - tj * sx] += 1
                    m[img, ti, tj] = max(m[img, ti, tj],
                                         np.float32(best).view(np.uint32))
    # every pixel of every window met by exactly one unit and lane
    assert seen.min() == seen.max() == 1
    return m.view(np.float32)


# (image cells, tile): the default tile of a 70 x 140 grid (35, 70), and
# tiles of 1-5 cells, where a 16 x 16 block meets up to a hundred windows
MAX_CASES = (((70, 140), None), ((20, 13), (1, 1)), ((20, 13), (2, 3)),
             ((20, 13), (3, 5)))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("cells,tile", MAX_CASES,
                         ids=["default", "1x1", "2x3", "3x5"])
def test_epilogue_maxima_equal_tile_max_plain(cells, tile, dtype):
    """The epilogue's walk gives tile_max_plain's maxima, bit for bit, in
    both storage types, NaN dropped by both."""
    tile = tile or stack.default_tile(*cells)
    tr, tc = tile
    ny, nx = -(-cells[0] // tr), -(-cells[1] // tc)
    rng = np.random.default_rng(tr * 10 + tc)
    # the epilogue's f32 values and x5 as stored
    pre = (rng.standard_normal((1, 2 * ny * tr + 4, 2 * nx * tc + 4, 128),
                               dtype=np.float32)
           * rng.random((1, 1, 1, 128), dtype=np.float32))
    pre[0, 5, 7, 3] = np.nan
    pre[0, -1, -1, :] = np.nan   # a pixel of nothing but NaN
    x5 = torch.from_numpy(pre).to(dtype)
    cover = fragment_pixels()
    assert cover.min() == cover.max() == 1
    m = emulate_epilogue(pre, tile, dtype)
    ref = stack.tile_max_plain(x5, tile)
    assert ref.shape == (1, ny, nx) and not torch.isnan(ref).any()
    assert np.array_equal(m.view(np.uint32), ref.numpy().view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("tile", [(4, 8), (1, 1), (3, 5)],
                         ids=["4x8", "1x1", "3x5"])
def test_layer5_maxima_plain(sps, dtype, tile):
    """layer5_maxima on the CPU: layer 5 as mma_layer computes it, and
    tile_max_plain of that x5; l6_i8_layer given those maxima equals it
    without them; the scales are the maxima / 127 (max with 1e-8)."""
    sp = sps[dtype]
    tr, tc = tile
    ny, nx = 2, 3
    rng = np.random.default_rng(tr + 7 * tc)
    x4 = torch.from_numpy(rng.random(
        (2, 2 * ny * tr + 6, 2 * nx * tc + 6, 64), dtype=np.float32)).to(dtype)
    x5, m = stack.layer5_maxima(x4, sp, tile)
    assert torch.equal(x5, stack.mma_layer(x4, sp, 5))
    assert torch.equal(m, stack.tile_max_plain(x5, tile))
    x6t, sx = stack.l6_i8_layer(x5, sp, tile)
    x6m, sxm = stack.l6_i8_layer(x5, sp, tile, m=m)
    assert torch.equal(x6t, x6m) and torch.equal(sx, sxm)
    assert torch.equal(sx, torch.clamp(m, min=1e-8) * stack._INV127)


def test_maxima_argument_checks(sps):
    sp = sps[torch.float32]
    with pytest.raises(ValueError, match="x4 must be"):
        stack.layer5_maxima(torch.zeros((1, 21, 31, 64)), sp, (4, 8))
    with pytest.raises(ValueError, match="x4 must be"):
        stack.layer5_maxima(torch.zeros((1, 22, 38, 32)), sp, (4, 8))
    with pytest.raises(ValueError, match="x5 must be"):
        stack.l6_i8_layer(torch.zeros((1, 21, 36, 128)), sp, (4, 8))
    x5 = torch.zeros((1, 20, 36, 128))
    with pytest.raises(ValueError, match="m must be"):
        stack.l6_i8_layer(x5, sp, (4, 8), m=torch.zeros((1, 2, 3)))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_l6_i8_layer_off_the_cpu_needs_the_maxima(params_np, dtype):
    """Off the CPU, l6_i8_layer takes the tile maxima from its caller (as
    the stacks take them from layer 5's epilogue) and refuses m=None before
    it launches anything; the CPU's plain version takes them itself."""
    sp = stack.prep_params(params_from_numpy(params_np), dtype, "meta")
    x5 = torch.zeros((1, 20, 36, 128), dtype=dtype, device="meta")
    stack.reset_launches()
    with pytest.raises(ValueError, match="needs the tile maxima m"):
        stack.l6_i8_layer(x5, sp, (4, 8))
    assert stack.LAUNCHES == 0 and not any(stack.I8_LAUNCHES.values())


def test_stack_scale_i8_plain_matches_pallas_interpret(params_np, sps):
    """The B4 stack's plain version against the JAX kernel (interpret mode,
    f32) at one tile geometry, within a tenth of what int8 itself costs
    (max and rms), as tests/test_torch_l6.py holds it; and its tiles'
    scales are tile_max_plain's maxima of the stored x5 / 127."""
    kp = jps.prep_params(params_np, scale_input=True, dtype=jnp.float32)
    sp = sps[torch.float32]
    shape, tile = (1, 32, 32), (8, 16)
    ylow = np.random.default_rng(20).random(shape, dtype=np.float32)
    arrays, spec = kp
    (tr, tc), (_, hl, wl) = tile, shape
    ny, nx = -(-hl // tr), -(-wl // tc)
    xcol = jps._xcol_scale(jnp.asarray(ylow), tr, tc)

    def jax_stack(**kw):
        return np.asarray(jps._run_stack(xcol, arrays, tr, tc, ny, nx, spec,
                                         interpret=True, **kw))[:, :hl, :wl]

    t = torch.from_numpy(ylow)
    got = stack.stack_scale(t, sp, l6_i8=True, tile=tile).numpy()
    ref, ref_direct = jax_stack(l6_i8=True), jax_stack()
    cost = ref - ref_direct
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 0.1 * np.abs(cost).max()
    assert (np.sqrt(((got - ref) ** 2).mean())
            <= 0.1 * np.sqrt((cost ** 2).mean()))
    x5 = stack.layer5_plane(t, sp, tile)
    _, sx = stack.l6_i8_layer(x5, sp, tile)
    assert torch.equal(sx, torch.clamp(stack.tile_max_plain(x5, tile),
                                       min=1e-8) * stack._INV127)


def test_rounding_commutes_with_max():
    """The bf16 epilogue takes max |x| of the f32 values and rounds it once:
    rounding to nearest even is monotonic and odd, so that is the max of
    the stored values' |x|, bit for bit (ties, subnormals, signed zeros,
    infinities and NaN among the values)."""
    rng = np.random.default_rng(7)
    v = rng.standard_normal((4096, 64)).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-40, 38, (4096, 1)).astype(np.float32)
    ties = (rng.integers(0, 2 ** 16, (256, 64)).astype(np.uint32) << 16
            | np.uint32(0x8000))
    v[:256] = ties.view(np.float32)
    v[256, :4] = (-0.0, 0.0, np.inf, -np.inf)
    v[257, 3] = np.nan
    v = np.where(np.isnan(v) & (np.arange(4096)[:, None] != 257), 0.0, v)
    t = torch.from_numpy(v)
    stored = t.to(torch.bfloat16).float().abs()
    stored = torch.where(torch.isnan(stored), torch.zeros_like(stored),
                         stored).amax(dim=1)
    pre = torch.from_numpy(np.fmax.reduce(np.abs(v), axis=1, initial=0.0))
    once = pre.to(torch.bfloat16).float()
    assert torch.equal(once.view(torch.int32), stored.view(torch.int32))


# --- which C entry a call reaches ---------------------------------------------

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


# (shape, tile) of the int8 stack calls: a whole grid of (4, 16) tiles, and
# an odd guard size on a tile that leaves ragged tiles at both edges
I8_ROUTE_CASES = (((2, 20, 36), (4, 16)), ((2, 37, 53), (4, 16)))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape,tile", I8_ROUTE_CASES,
                         ids=["epilogue", "odd"])
@pytest.mark.parametrize("kind", ["scale", "noise", "dense", "fused_u8"])
def test_i8_maxima_route(sps, fake_card, dtype, shape, tile, kind):
    """Every int8 stack call takes the tile maxima in layer 5's epilogue (7
    launches) into a fresh [n, ny, nx] buffer that the int8 layer then
    reads, over the plane edge-extended to the tile grid, at a whole grid
    and at an odd size."""
    sp = sps[dtype]
    n, h, w = shape
    tr, tc = tile
    hl, wl = (-(-h // 2), -(-w // 2)) if kind == "noise" else (h, w)
    stack._launch(torch.zeros((n, h, w), dtype=dtype), sp, kind, None,
                  uvp=(torch.zeros((n, h, w, 8)) if kind == "fused_u8"
                       else None),
                  tc=32 if kind == "dense" else 0, form="i8", tile=tile)
    names = [fn for fn, _ in fake_card]
    bf16 = dtype == torch.bfloat16
    mid = "w2x_mma_layer" if bf16 else "w2x_tf32_layer"
    ny, nx = -(-hl // tr), -(-wl // tc)
    assert names[4:6] == [mid + "_max", "w2x_l6_i8_mma"]
    l5 = fake_card[4][1]
    # ..., m, tr, tc, ny, nx, stream; layer 5's input plane
    assert l5[-5:-1] == (tr, tc, ny, nx)
    assert l5[-9:-7] == (2 * tr * ny + 6, 2 * tc * nx + 6)
    assert fake_card[5][1][5] == l5[-6]
    # the int8 layer: (..., m, x6, n, tr, tc, ny, nx, stream)
    assert fake_card[5][1][-6:-1] == (n, tr, tc, ny, nx)
    assert len(names) == 7 == stack.LAUNCHES
    assert stack.I8_LAUNCHES == {"mma": 1, "l5max": 1}
    assert stack.MID_LAUNCHES["mma" if bf16 else "mma_tf32"] == 4


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_layer5_maxima_alone_dispatch(sps, fake_card, dtype):
    """Layer 5 with the maxima as layer5_maxima launches it on the card: one
    launch of the instance with them, m and the tiling passed, counted under
    MID_LAUNCHES and I8_LAUNCHES["l5max"] only."""
    sp = sps[dtype]
    x4 = torch.zeros((1, 2 * 2 * 4 + 6, 2 * 3 * 8 + 6, 64), dtype=dtype)
    tiling = stack._check_x4(x4, sp, (4, 8))
    assert tiling == (4, 8, 2, 3)
    x5 = torch.zeros((1, 20, 52, 128), dtype=dtype)
    m = torch.zeros((1, 2, 3))
    stack._Launcher(None, x4, None).layer5_max(x4, sp, x5, 1, 22, 54, m,
                                               tiling)
    (fn, args), = fake_card
    bf16 = dtype == torch.bfloat16
    assert fn == "w2x_mma_layer_max" if bf16 else "w2x_tf32_layer_max"
    assert args[-6] == m.data_ptr() and args[-5:-1] == (4, 8, 2, 3)
    assert args[-9:-7] == (22, 54)
    # the tile kernel's instance (the persistent kernel has no maxima)
    assert args[-7] == (stack.mma_plan(64, 128, persistent=False) if bf16
                        else stack.tf32_plan(64, 128)).smem_bytes
    assert stack.LAUNCHES == 0 and stack.I8_LAUNCHES["l5max"] == 1
    assert stack.MID_LAUNCHES["mma" if bf16 else "mma_tf32"] == 1
    assert stack.MID_LAUNCHES["mma_tile"] == int(bf16)
    assert stack.I8_LAUNCHES == {"mma": 0, "l5max": 1}


def _entries() -> dict:
    """Each C entry of csrc/*.cu -> its parameter count."""
    out = {}
    for path in CSRC.glob("*.cu"):
        for name, params in re.findall(r"^int (w2x_\w+)\(([^)]*)\)",
                                       path.read_text(), re.M):
            out[name] = len(params.split(","))
    return out


@pytest.mark.parametrize("src", sorted(p.name for p in CSRC.glob("*.cu")))
def test_c_source_answers_for_its_errors_and_asks_the_sms_once(src):
    """Every CUDA source includes common.cuh, so its library exports
    w2x_error_string for its own error codes (the wrappers read the
    message from the library whose call failed), defines no error string
    of its own, and asks the SM count of the current device only through
    common.cuh's sm_count, at each launch (no count kept for the
    process)."""
    text = (CSRC / src).read_text()
    assert re.search(r'^#include "common\.cuh"', text, re.M)
    assert not re.search(r"\bw2x_\w*error_string\(int", text)
    assert "cudaDevAttrMultiProcessorCount" not in text
    assert not re.search(r"static int sms\b", text)
    common = (CSRC / "common.cuh").read_text()
    assert common.count("cudaDevAttrMultiProcessorCount") == 1
    assert re.search(r'extern "C" \{\s*(//[^\n]*\n\s*)*const char\* '
                     r"w2x_error_string\(int err\)", common)


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in
                                    stack._ARGTYPES.items() for fn in fns])
def test_c_entry_parameter_count(lib, fn):
    """Every entry in the ctypes table exists in its source with as many
    parameters as the table gives it."""
    src = (CSRC / f"{lib}.cu").read_text()
    assert re.search(rf"^int {fn}\(", src, re.M), f"{fn} not in {lib}.cu"
    assert _entries()[fn] == len(stack._ARGTYPES[lib][fn])
