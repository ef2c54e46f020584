"""probe_fetch_reduce and probe_l1_mm as designed for Hopper
(waifu2x_torch/csrc/probe.cu) on the CPU: what can be held without a card.

The kernels' product is emulated from their source's own geometry and held
to the plain versions and to the JAX tool's body (stage_time.py:241,
restated as tests/test_torch_probe.py runs it, in Pallas interpret mode):
l1_mm's A fragments formed from each cell row's 18-byte pixels, K padded
to 16, times the wrapper's packed weight, rounded once, lanes 0-3 planar.
The persistent walks are emulated and shown to visit every cell (or cell
row) once; the lane-0 sums' tile order is shown to bring the four readers
of a tile to it at one step. The traffic sum (ops/probe.py:traffic_sum) is
held to the copies that the producer issues, and shown to see a block that
a cell drops or reads twice. The kernels themselves are held against the
plain versions on the card by chip_smoke.py (phase 18)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_torch.ops import probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "waifu2x_torch" / "csrc" / "probe.cu").read_text()
B, NY, NX, TR, TC = 2, 2, 2, 16, 32   # tests/test_torch_probe.py's grid
G = probe.Grid(B, NY, NX, TR, TC)
JAX_GRID = probe.Grid(16, 8, 4)         # stage_time's and grid_floor's
REDUCE = ("cin1", "cin4", "cin9", "4-fetch")
BF = jnp.bfloat16


def _consts() -> dict:
    """The two kernels' `constexpr int RED_* / MM_* = expr;` values
    (expressions of numbers and earlier names; RED_SLOTS_MAX and
    RED_SLOTS_SUM share a line)."""
    vals = {}
    decls = re.findall(r"constexpr int ((?:(?:RED|MM)_\w+ = [^,;]+,? ?)+);",
                       SRC)
    for decl in decls:
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            vals[name] = int(eval(expr, {}, dict(vals)))
    return vals


def _order(v: probe.Variant, i: int, j: int) -> int:
    """The kernel's red_order: step s of cell (i, j) reads block
    s ^ order."""
    return ((i & 1) << 1) | (j & 1) if v.op == "lane0_sum" else 0


def _cell(c: int, g: probe.Grid) -> tuple:
    return c // (g.ny * g.nx), (c // g.nx) % g.ny, c % g.nx


# --- probe_l1_mm -------------------------------------------------------------

def test_packed_l1_mm_weight():
    """B of the product: K padded from 9 to 16 by zeros, [k8][n][8]."""
    w = probe.make_inputs(probe.VARIANTS["cin9mm"], G, 3, "cpu")["w"]
    wp = probe.pack_l1_mm(w)
    assert wp.shape == (2, 128, 8) and wp.dtype == torch.bfloat16
    assert wp.is_contiguous() and wp.numel() * 2 == _consts()["MM_W_BYTES"]
    for k in range(16):
        want = w[k] if k < 9 else torch.zeros(128, dtype=torch.bfloat16)
        assert torch.equal(wp[k // 8, :, k % 8], want)


def _u32(raw: np.ndarray, at: np.ndarray) -> np.ndarray:
    """Little-endian words of each cell row's bytes at byte offsets `at`."""
    b = raw[:, at[:, None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _l1_mm_kernel(g: probe.Grid, x: torch.Tensor, w: torch.Tensor):
    """probe_l1_mm's function as the kernel computes it: per cell row and
    pixel x, A[k = 2q, 2q + 1] the word pair at byte 18x + 4q (aligned
    words and a funnel shift where 18x + 4q is not a multiple of 4),
    A[8] the bf16 at 18x + 16, A[9..15] zero; times pack_l1_mm's B in
    f32; the products' lanes 0-3 rounded to bf16 once, planar."""
    v = probe.VARIANTS["cin9mm"]
    blocks = probe.cells(x, probe.block("tile", "x9", g), g)
    rows = blocks.reshape(-1, g.tc * 9).contiguous().view(torch.int16)
    raw = rows.numpy().view(np.uint8)
    raw = np.concatenate([raw, np.zeros((raw.shape[0], 4), np.uint8)], 1)
    xs = np.arange(g.tc)
    a = np.zeros((raw.shape[0], g.tc, 16), np.uint32)
    for q in range(4):
        at = 18 * xs + 4 * q
        w0, w1 = _u32(raw, at & ~3), _u32(raw, (at & ~3) + 4)
        pair = np.where((at & 2) != 0, (w0 >> 16) | (w1 << 16), w0)
        a[..., 2 * q], a[..., 2 * q + 1] = pair & 0xFFFF, pair >> 16
    a[..., 8] = _u32(raw, 18 * xs + 16) & 0xFFFF
    af = (a << 16).view(np.float32)
    bk = probe.pack_l1_mm(w).permute(0, 2, 1).reshape(16, 128).float()
    acc = torch.from_numpy(af) @ bk
    lanes = acc[..., :4].to(torch.bfloat16).reshape(
        g.batch, g.ny, g.nx, g.tr, g.tc, 4).transpose(-1, -2)
    o = probe.out_spec(v.out, g)
    return probe._assemble(lanes.reshape(*lanes.shape[:4], 4 * g.tc), o, g)


@pytest.mark.parametrize("seed", [0, 5])
def test_l1_mm_kernel_equals_plain_on_exact_inputs(seed):
    """On make_inputs' k / 256 inputs every sum is exact: the emulated
    kernel equals l1_mm_plain bit for bit; the formed A is not trivially
    right (a pixel read 2 bytes late differs)."""
    v = probe.VARIANTS["cin9mm"]
    args = probe.make_inputs(v, G, seed, "cpu")
    got = _l1_mm_kernel(G, args["x"], args["w"])
    ref = probe.l1_mm_plain(v, G, args["x"], args["w"])
    assert probe.compare(got, ref)[2]
    late = torch.roll(args["x"], -1)
    assert not probe.compare(_l1_mm_kernel(G, late, args["w"]), ref)[2]


def test_l1_mm_kernel_equals_the_jax_body():
    """The JAX body of tools/stage_time.py:241 in interpret mode on the
    same k / 256 inputs, drawn with numpy."""
    rng = np.random.default_rng(11)
    xs = (rng.integers(0, 256, probe.array_shape("x9", G)) / 256).astype(
        np.float32)
    ws = (rng.integers(0, 256, (9, 128)) / 256).astype(np.float32)
    xj, wj = jnp.asarray(xs).astype(BF), jnp.asarray(ws).astype(BF)

    def spec(shape, index_map):
        return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)

    def bin9mm(xa, w, out, x1):
        x1[...] = jax.lax.dot_general(
            xa[0], w[...], dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(BF)
        out[0] = jnp.concatenate(
            [x1[:, :, 0], x1[:, :, 1], x1[:, :, 2], x1[:, :, 3]], axis=-1)

    ref = pl.pallas_call(
        bin9mm, grid=(B, NY, NX),
        in_specs=[spec((1, TR, TC, 9), lambda n, i, j: (n, i, j, 0)),
                  spec((9, 128), lambda n, i, j: (0, 0))],
        out_specs=spec((1, TR, 4 * TC), lambda n, i, j: (n, i, j)),
        out_shape=jax.ShapeDtypeStruct((B, NY * TR, NX * 4 * TC), BF),
        scratch_shapes=[pltpu.VMEM((TR, TC, 128), BF)], interpret=True)(
            xj, wj)
    got = _l1_mm_kernel(G, torch.from_numpy(xs).to(torch.bfloat16),
                        torch.from_numpy(ws).to(torch.bfloat16))
    ref_bits = np.array(jax.lax.bitcast_convert_type(ref, jnp.uint16))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), ref_bits)


@pytest.mark.parametrize("tc", [32, 48, 128])
def test_l1_mm_walk_covers_every_pixel_once(tc):
    """The kernel's walk: cell row u = blockIdx.x + t gridDim.x for its
    producer's t; team t % 4; a team's warp wl its 16-pixel strips xs =
    16 wl + 64 m. Every (row, pixel) once, at 132 SMs; and the ring is
    deep enough for the producer warp's 32 lanes and every team."""
    c = _consts()
    teams, slots = c["MM_TEAMS"], c["MM_SLOTS"]
    assert slots >= 32 + teams
    units, sms = 3 * 8 * 4 * 16, 132
    blocks = min(units, sms)
    seen = np.zeros((units, tc), int)
    for b in range(blocks):
        for team in range(teams):
            for t in range(team, units, teams):
                u = b + t * blocks
                if u >= units:
                    break
                for wl in range(4):
                    for xs in range(16 * wl, tc, 64):
                        seen[u, xs:xs + 16] += 1
    assert (seen == 1).all()
    assert "for (int xs = 16 * wl; xs < tc; xs += 64)" in SRC
    assert "u += MM_TEAMS * gridDim.x, t += MM_TEAMS" in SRC


# --- probe_fetch_reduce ------------------------------------------------------

@pytest.mark.parametrize("cells,sms", [(512, 132), (8, 132), (132, 132),
                                       (133, 132), (1000, 114)])
def test_reduce_walk_visits_every_cell_once(cells, sms):
    """Cell blockIdx.x + k gridDim.x on min(cells, SMs) blocks: every cell
    once, and the cells in flight at step k are consecutive (they share
    their neighbours' blocks through L2)."""
    blocks = min(cells, sms)
    walk = [list(range(b, cells, blocks)) for b in range(blocks)]
    assert sorted(c for w in walk for c in w) == list(range(cells))
    for k in range(max(map(len, walk))):
        step = [w[k] for w in walk if len(w) > k]
        assert step == list(range(k * blocks, k * blocks + len(step)))
    assert SRC.count("for (int c = blockIdx.x; c < a.cells; "
                     "c += gridDim.x") == 2   # the producer and consumers
    assert "cells < sms ? cells : sms" in SRC


def test_lane0_tiles_meet_at_one_step():
    """4-fetch: step s of cell (i, j) reads block s ^ order(i, j), the tile
    (i + di, j + dj) of block 2 di + dj; every reader of a tile reads it at
    the step of the tile's own parities."""
    v = probe.VARIANTS["4-fetch"]
    offs = [(b.rb // JAX_GRID.tr, b.cb // JAX_GRID.tc) for b in (
        probe.block(k, v.array, JAX_GRID) for k in v.ins)]
    assert offs == [(0, 0), (0, 1), (1, 0), (1, 1)]
    step_of = {}
    for i in range(JAX_GRID.ny):
        for j in range(JAX_GRID.nx):
            read = []
            for s in range(4):
                di, dj = offs[s ^ _order(v, i, j)]
                tile = (i + di, j + dj)
                read.append(tile)
                assert step_of.setdefault(tile, s) == s
                assert s == 2 * (tile[0] & 1) + (tile[1] & 1)
            assert sorted(read) == sorted((i + di, j + dj) for di, dj in offs)
    assert "((i & 1) << 1) | (j & 1)" in SRC
    assert "a.in[s ^ order]" in SRC and "const int k = s ^ order;" in SRC


@pytest.mark.parametrize("tc", [32, 48, 128])
def test_stash_entries_are_read_by_their_writer(tc):
    """The 4-fetch's consumers stash tile a's pixel r0 * cols + p of each
    slot on thread (r0 * cols + p) % RED_CONS, the thread that adds s to it
    after the cell's last slot (q = tid + RED_CONS m), whatever the slot's
    rows (48 columns: 10 rows a slot, 480 pixels)."""
    c = _consts()
    cons, lanes, rows = c["RED_CONS"], 16, 64
    rpc = min(32, c["RED_SLOT"] // (2 * tc * lanes))
    writer = {}
    for r0 in range(0, rows, rpc):
        n_px = min(rpc, rows - r0) * tc
        for tid in range(cons):
            for p in range((tid - r0 * tc) & (cons - 1), n_px, cons):
                assert r0 * tc + p not in writer
                writer[r0 * tc + p] = tid
    assert writer == {q: q % cons for q in range(rows * tc)}
    assert "(tid - r0 * b.cols) & (RED_CONS - 1)" in SRC
    assert "for (int q = tid; q < a.in[0].rows * cols; q += RED_CONS)" in SRC


def _copies(v: probe.Variant, g: probe.Grid):
    """The producer's copies, in order: (n, i, j, block, first row,
    rows), a slot of at most RED_SLOT bytes and 32 rows (a lane a row)."""
    slot = _consts()["RED_SLOT"]
    bs = [probe.block(k, v.array, g) for k in v.ins]
    for c in range(g.cells):
        n, i, j = _cell(c, g)
        for s in range(len(bs)):
            k = s ^ _order(v, i, j)
            rpc = min(32, slot // (2 * bs[k].cols * bs[k].lanes))
            for r0 in range(0, bs[k].rows, rpc):
                yield n, i, j, k, r0, min(rpc, bs[k].rows - r0)


def _words(x, v, g, copy) -> torch.Tensor:
    n, i, j, k, r0, nr = copy
    b = probe.block(v.ins[k], v.array, g)
    rows = probe.cells(x, b, g)[n, i, j, r0:r0 + nr]
    return rows.reshape(nr, -1).contiguous().view(torch.int32).long()


@pytest.mark.parametrize("name", REDUCE)
def test_kernel_copies_sum_to_the_traffic_sum(name):
    """Every word the producer's copies land, summed mod 2^32, is
    traffic_sum_plain (and the wrapper's CPU path); each cell's blocks are
    landed whole, once."""
    v = probe.VARIANTS[name]
    args = probe.make_inputs(v, G, 1, "cpu")
    copies = list(_copies(v, G))
    total = sum(int(_words(args["x"], v, G, c).sum()) for c in copies)
    ref = probe.traffic_sum_plain(v, G, args["x"])
    assert total % 2**32 == ref == probe.traffic_sum(v, G, args)
    rows = {}
    for n, i, j, k, r0, nr in copies:
        for r in range(r0, r0 + nr):
            key = (n, i, j, k, r)
            rows[key] = rows.get(key, 0) + 1
    want = G.cells * sum(probe.block(k, v.array, G).rows for k in v.ins)
    assert len(rows) == want and set(rows.values()) == {1}


@pytest.mark.parametrize("name", REDUCE)
def test_traffic_sum_sees_a_block_dropped_or_read_twice(name):
    """A copy dropped, or one cell's block landed twice, changes the sum;
    an xor of the words (the fold of the map kernels) would cancel the
    block read twice."""
    v = probe.VARIANTS[name]
    x = probe.make_inputs(v, G, 2, "cpu")["x"]
    copies = list(_copies(v, G))
    ref = probe.traffic_sum_plain(v, G, x)
    dropped = sum(int(_words(x, v, G, c).sum()) for c in copies[1:])
    assert dropped % 2**32 != ref
    n, i, j = _cell(G.cells - 1, G)
    blk = [c for c in copies if c[:4] == (n, i, j, len(v.ins) - 1)]
    twice = sum(int(_words(x, v, G, c).sum()) for c in copies + blk)
    assert twice % 2**32 != ref

    def xor(cs):
        acc = 0
        for c in cs:
            acc ^= int(np.bitwise_xor.reduce(
                _words(x, v, G, c).numpy().ravel()))
        return acc

    assert xor(copies + blk + blk) == xor(copies)


@pytest.mark.parametrize("name,bound", [
    ("cin1", 0.0501), ("cin4", 0.0520), ("cin9", 0.0326),
    ("4-fetch", 0.0664), ("cin9mm", 0.0326)])
def test_bounds_at_the_jax_grids(name, bound):
    """The bounds stay where they were: distinct bytes at 3.35 TB/s (the
    products of cin9mm at 989 TFLOP/s take less)."""
    v = probe.VARIANTS[name]
    t_bytes = probe.distinct_bytes(v, JAX_GRID) / probe.PEAK_BYTES * 1e3
    t_ops = probe.flops(v, JAX_GRID) / probe.PEAK_BF16_FLOPS * 1e3
    assert t_ops < t_bytes and round(t_bytes, 4) == bound


# --- the wrappers of the two C entries ---------------------------------------

def test_new_entries_refuse_what_the_kernels_do_not_take():
    v = probe.VARIANTS["cin1"]
    args = probe.make_inputs(v, G, 0, "cpu")
    for other in ("ccat", "c4", "cin9mm"):
        w = probe.VARIANTS[other]
        with pytest.raises(ValueError, match="probe_fetch_reduce"):
            probe.traffic_sum(w, G, probe.make_inputs(w, G, 0, "cpu"))
    with pytest.raises(ValueError, match="takes"):
        probe.traffic_sum(v, G, {})
    with pytest.raises(ValueError, match="contiguous"):
        probe.traffic_sum(v, G, {"x": args["x"].float()})
    with pytest.raises(ValueError, match="tile"):
        g = probe.Grid(1, 1, 1, 12, 32)
        probe.traffic_sum(v, g, {"x": torch.zeros(
            probe.array_shape("x16", g), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match=r"\(9, 128\)"):
        probe.pack_l1_mm(torch.zeros((16, 128), dtype=torch.bfloat16))


def test_c_arguments_of_the_new_entries():
    """fetch_reduce takes a sink and its words (none from the timed
    wrappers), at least cells x RED_THREADS of them, RED_THREADS the
    kernel's block; l1_mm takes the packed weight, kept alive."""
    c = _consts()
    assert probe.RED_THREADS == c["RED_THREADS"] == 32 * c["RED_WARPS"] + 32
    assert "sink_words < (long long)cells * RED_THREADS" in SRC
    v = probe.VARIANTS["4-fetch"]
    args = probe.make_inputs(v, G, 0, "cpu")
    out = torch.empty(probe.out_spec(v.out, G).shape(G), dtype=torch.bfloat16)
    n_args = len(probe._ARGTYPES["w2x_probe_fetch_reduce"]) - 1   # + stream
    plain = probe._c_args(v, G, args, out)
    assert len(plain) == n_args and plain[-2:] == (None, 0)
    sink = torch.zeros(G.cells * probe.RED_THREADS, dtype=torch.int32)
    assert probe._c_args(v, G, args, out, sink)[-2:] == (sink.data_ptr(),
                                                        sink.numel())
    mm = probe.VARIANTS["cin9mm"]
    margs = probe.make_inputs(mm, G, 0, "cpu")
    keep = []
    cargs = probe._c_args(mm, G, margs, out, keep=keep)
    assert len(cargs) == len(probe._ARGTYPES["w2x_probe_l1_mm"]) - 1
    assert cargs[2] == keep[-1].data_ptr()
    assert torch.equal(keep[-1], probe.pack_l1_mm(margs["w"]))
