"""probe_fetch_map's ring form as designed for Hopper (csrc/probe.cu:
probe_fetch_map, persistent, block rows staged by TMA into a ring) on the
CPU: what can be held without a card.

The router (w2x_probe_fetch_map, modelled here as _route; on the card the
entry reports the kernel it launched, counted in probe.MAP_ROUTES, which
chip_smoke.py holds) sends exactly seven variants to the ring form:
dma_probe.py:55's lane16_x4, lane128 and lane128_x4, dma_probe2.py:50's
in16+o128, in128+o128 and raw+o128, and l14_probe.py:145's xonly. For each,
the kernel's walk (_walk: the cells dealt to the persistent blocks, each
cell's head copies and ring slots, in the geometry of fm_geometry, _geometry
here) is emulated at the JAX tools' grid and at a small odd grid dealt over
four blocks, and in the wide geometry (rows wider than a slot, stripes wider
than the head buffer) at grids no tool runs: every row of every block a
BlockSpec names lands (whole, inside its slot or half of the head buffer, no
two copies overlapping), every 16-byte output vector is written exactly
once, and the output that the consumers build from the staged bytes (the
vector path's reads, the f32 sums in the order ((a + b) + c) + d, the map,
one rounding) equals fetch_map_plain bit for bit, on inputs whose sums round
differently in another order. The stripes are shown to land at their
neighbours' steps, and the geometry to take every input the earlier
row-split kernel took. The kernel itself is held against the plain version
on the card by chip_smoke.py (phase 18)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from waifu2x_torch.ops import probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "waifu2x_torch" / "csrc" / "probe.cu").read_text()
RING = ("lane16_x4", "lane128", "lane128_x4", "in16+o128", "in128+o128",
        "raw+o128", "xonly")
SMS = 132                                # an H100's SMs: the grid's size
JAX_GRID = probe.Grid(4, 8, 4)          # dma_probe's and l14_probe's
ODD_GRID = probe.Grid(3, 3, 5, 8, 32)   # 45 cells over 4 blocks
GRIDS = [(JAX_GRID, SMS), (ODD_GRID, 4)]
GRID_IDS = ["jax-grid", "odd-grid"]
# the wide geometry: a tile row and its right stripe's over a slot (tc 512,
# 1024), or the stripes over the head buffer (tc 256)
WIDE = [("lane16_x4", probe.Grid(1, 2, 2, 8, 512)),
        ("lane16_x4", probe.Grid(1, 2, 3, 16, 1024)),
        ("xonly", probe.Grid(1, 3, 2, 64, 256)),
        ("lane128", probe.Grid(1, 2, 3, 16, 1024)),
        ("in16+o128", probe.Grid(1, 2, 3, 16, 1024))]
WIDE_IDS = ["x4-512", "x4-1024", "x4-stripes", "rep8-1024", "const0-1024"]


def _fm_consts() -> dict:
    """The ring form's `constexpr int FM_* = expr;` values (FM_SLOTS_1 and
    FM_SLOTS_4 share a line)."""
    vals = {}
    for decl in re.findall(r"constexpr int ((?:FM_\w+ = [^,;]+,? ?)+);", SRC):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            vals[name] = int(eval(expr, {}, dict(vals)))
    return vals


FM = _fm_consts()
# (input lanes, output lanes, type) -> the maps probe_map_direct is compiled
# for (csrc/probe.cu: direct_map)
_DIRECT = {(16, 4, "bf16"): ("copy", "half", "affine", "lane0"),
           (1, 4, "bf16"): ("copy",), (16, 16, "u8"): ("u8", "u8_zero")}


def _route(v: probe.Variant, g: probe.Grid) -> str:
    """The kernel that w2x_probe_fetch_map launches for a fetch_map variant,
    as modelled from its conditions: "direct" (probe_map_direct) or
    "planar" (probe_map_planar), the hot forms of one block with no repeat
    whose output row holds every pixel of the block row, or "ring" for the
    rest."""
    b, o = probe.block(v.ins[0], v.array, g), probe.out_spec(v.out, g)
    if len(v.ins) == 1 and v.rep == 1 and o.xg == b.cols and (
            v.op != "const0"):
        if o.form == "lanes" and v.op in _DIRECT.get(
                (b.lanes, o.lg, o.dtype), ()):
            isz = probe._DTYPES[o.dtype].itemsize
            grp = max(1 if 2 * b.lanes >= 16 else 16 // (2 * b.lanes),
                      1 if o.lg * isz >= 16 else 16 // (o.lg * isz))
            if b.cols % grp == 0 and (o.rows * (b.cols // grp)) % 256 == 0:
                return "direct"
        if (o.form == "planar" and b.lanes == 16 and o.lg == 4
                and o.dtype == "bf16" and v.op in ("copy", "half")
                and o.rows % 8 == 0 and b.cols % 8 == 0):
            return "planar"
    return "ring"


def _geometry(rb: list, rows: list):
    """fm_geometry for block rows of rb[k] bytes and rows[k] rows -> (slot
    bytes, slots, stripes in the head buffer, tile rows a slot), or None
    where the entry refuses."""
    x4 = len(rb) == 4
    row = rb[0] + (rb[1] if x4 else 0)
    if min(rb) <= 0:
        return None
    stripes = rows[2] * rb[2] + rows[3] * rb[3] if x4 else 0
    if row <= FM["FM_SLOT"] and stripes <= FM["FM_HEAD"]:
        sb, slots, head = FM["FM_SLOT"], FM["FM_SLOTS_4" if x4
                                            else "FM_SLOTS_1"], x4
    else:
        sb = max([row, FM["FM_SLOT"]] + rb[2:])
        if sb > FM["FM_SMEM"]:
            return None
        slots, head = (FM["FM_SMEM"] - 32) // (sb + 16), False
        if slots < 1:
            return None
    return sb, slots, head, min(32, sb // row)


def _walk(v: probe.Variant, g: probe.Grid, sms: int = SMS) -> list:
    """probe_fetch_map's ring form step by step, as its producer warp
    issues the copies -> for each of min(cells, sms) blocks its cells in
    order (cell blockIdx.x + k gridDim.x), each a dict:
      "cell"    (n, i, j);
      "head"    the head buffer's half (k & 1) and its copies (block, row,
                byte offset): with the stripes in the head buffer, the lower
                stripe's rows, then the diagonal's, whole;
      "slots"   the tile's steps as (ring step t, slot t % slots, first row
                r0, rows nr, copies): tile rows r0 .. r0 + nr - 1 at
                r * rb0, with four blocks the right stripe's same rows
                after `rpc` tile rows;
      "passes"  the wide geometry's stripe steps, (t, slot, copies), each
                copy a lower or diagonal row landed and not read;
    and the geometry under "rpc", "rb", "sb" and "head_on"."""
    bs = [probe.block(k, v.array, g) for k in v.ins]
    rb = [b.cols * b.lanes * 2 for b in bs]
    sb, slots, head_on, rpc = _geometry(rb, [b.rows for b in bs])
    x4 = len(bs) == 4
    grid = min(g.cells, sms)
    walk = []
    for bid in range(grid):
        cells, t = [], 0
        for k, c in enumerate(range(bid, g.cells, grid)):
            n, i, j = c // (g.ny * g.nx), (c // g.nx) % g.ny, c % g.nx
            head = []
            if head_on:
                head = [(2, r, r * rb[2]) for r in range(bs[2].rows)]
                head += [(3, r, bs[2].rows * rb[2] + r * rb[3])
                         for r in range(bs[3].rows)]
            steps, passes = [], []
            for r0 in range(0, bs[0].rows, rpc):
                nr = min(rpc, bs[0].rows - r0)
                copies = [(0, r0 + r, r * rb[0]) for r in range(nr)]
                if x4:
                    copies += [(1, r0 + r, rpc * rb[0] + r * rb[1])
                               for r in range(nr)]
                steps.append((t, t % slots, r0, nr, copies))
                t += 1
            if x4 and not head_on:
                for kb in (2, 3):
                    per = min(32, sb // rb[kb])
                    for r0 in range(0, bs[kb].rows, per):
                        nr = min(per, bs[kb].rows - r0)
                        passes.append((t, t % slots, [
                            (kb, r0 + r, r * rb[kb]) for r in range(nr)]))
                        t += 1
            cells.append({"cell": (n, i, j), "head": (k & 1, head),
                          "slots": steps, "passes": passes, "rpc": rpc,
                          "rb": rb, "sb": sb, "head_on": head_on})
        walk.append(cells)
    return walk


def _inputs(v: probe.Variant, g: probe.Grid, seed: int) -> torch.Tensor:
    """x in bf16 with signs and exponents spread over 2^-20 .. 2^20, so that
    four-term f32 sums round, and differently in another order."""
    rng = np.random.default_rng(seed)
    shape = probe.array_shape(v.array, g)
    m = rng.uniform(1, 2, shape) * 2.0 ** rng.integers(-20, 21, shape)
    return torch.from_numpy(m * rng.choice([-1.0, 1.0], shape)).to(
        torch.bfloat16)


def _f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, round to nearest even (as __float2bfloat16_rn)."""
    return torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _row(x: np.ndarray, b: probe.Block, n, i, j, r) -> np.ndarray:
    """Row r of block b of cell (n, i, j), as bf16 bits [cols * lanes]."""
    x4 = x if x.ndim == 4 else x[..., None]
    r0, c0 = i * b.ra + b.rb + r, j * b.ca + b.cb
    return x4[n, r0, c0:c0 + b.cols].reshape(-1)


def _lanes(row, p, la, c, nl, bc):
    """The kernel's lanes_of: nl lanes from lane c of pixel p (arrays over
    the vectors), lane 0 in all where bc."""
    if bc:
        return np.repeat(_f32(row[p * la])[:, None], nl, 1)
    idx = (p * la + c)[:, None] + np.arange(nl)[None]
    return _f32(row[idx])


def _term(s, xs, la, c0, nl, bc, x4):
    """The kernel's term: t = ((a + b) + c) + d in f32, or a."""
    t = _lanes(s["a"], xs, la, c0, nl, bc)
    if x4:
        zero = np.zeros_like(xs)
        t = t + _lanes(s["b"], zero, la, c0, nl, bc)
        t = t + _lanes(s["c"], xs, la, c0, nl, bc)
        t = t + _lanes(s["d"], zero, la, c0, nl, bc)
    return t


def _emulate(v: probe.Variant, g: probe.Grid, x: torch.Tensor, sms: int):
    """probe_fetch_map's ring form, block by block as _walk deals the
    cells: each cell's head copies and slots staged in byte arrays as the
    producer lays them out, then each slot's output vectors built from the
    staged bytes by the vector path (map_vec) -> (output bits [cells, rows,
    q * 8], writes per output vector, landed rows per (block, cell))."""
    bs = [probe.block(k, v.array, g) for k in v.ins]
    o = probe.out_spec(v.out, g)
    xb = x.view(torch.int16).numpy().view(np.uint16)
    q = o.cols * o.lanes * 2 // 16
    out = np.zeros((g.cells, o.rows, q * 8), np.uint16)
    writes = np.zeros((g.cells, o.rows, q), int)
    landed = {}
    la, x4 = bs[0].lanes, len(bs) == 4
    lg, rep = o.lg.bit_length() - 1, v.rep.bit_length() - 1
    bc = la == 1 or v.op == "lane0"
    kv = np.arange(q)
    walk = _walk(v, g, sms)

    def stage(copies, cap, n, i, j, c):
        buf, spans = np.zeros(cap // 2, np.uint16), []
        for kb, r, off in copies:
            buf[off // 2:(off + rb[kb]) // 2] = _row(xb, bs[kb], n, i, j, r)
            spans.append((off, off + rb[kb]))
            landed[kb, c, r] = landed.get((kb, c, r), 0) + 1
        _disjoint(spans, cap)
        return buf

    for blk, cells in enumerate(walk):
        for k, cw in enumerate(cells):
            n, i, j = cw["cell"]
            c = (n * g.ny + i) * g.nx + j
            assert c == blk + k * len(walk)
            rpc, rb, sb = cw["rpc"], cw["rb"], cw["sb"]
            half, hcopies = cw["head"]
            assert half == k % 2
            head = stage(hcopies, FM["FM_HEAD"], n, i, j, c)
            if cw["head_on"]:
                s = {"c": head, "d": head[bs[2].rows * rb[2] // 2:]}
            elif x4:   # the wide geometry: row 0 from device memory
                s = {"c": _row(xb, bs[2], n, i, j, 0),
                     "d": _row(xb, bs[3], n, i, j, 0)}
            else:
                s = {}
            if v.op == "const0":   # stored before anything lands
                writes[c] += 1
            for _, _, copies in cw["passes"]:   # landed, not read
                stage(copies, sb, n, i, j, c)
            for t, slot, r0, nr, copies in cw["slots"]:
                sv = stage(copies, sb, n, i, j, c)
                if v.op == "const0":
                    continue
                for r in range(nr):
                    s["a"] = sv[r * rb[0] // 2:]
                    s["b"] = sv[(rpc * rb[0] + r * rb[1]) // 2:] if x4 \
                        else None
                    if lg >= 3:
                        e0 = 8 * kv
                        vals = _term(s, (e0 >> lg) >> rep, la,
                                     e0 & ((1 << lg) - 1), 8, bc, x4)
                    else:
                        vals = np.concatenate(
                            [_term(s, (2 * kv + p) >> rep, la, 0 * kv, 4, bc,
                                   x4) for p in (0, 1)], 1)
                    if v.op == "zero":
                        vals = vals * np.float32(0)
                    out[c, r0 + r] = _bf16_bits(vals).reshape(-1)
                    writes[c, r0 + r] += 1
    return out, writes, landed


def _disjoint(spans, cap) -> None:
    """Copies inside the buffer, no two overlapping, all 16-byte aligned."""
    spans = sorted(spans)
    assert all(a % 16 == 0 and (b - a) % 16 == 0 for a, b in spans)
    assert all(b <= cap for _, b in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))


def _assemble(out: np.ndarray, v: probe.Variant, g: probe.Grid):
    o = probe.out_spec(v.out, g)
    t = torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return probe._assemble(t.reshape(g.batch, g.ny, g.nx, o.rows, -1), o, g)


# --- the router -------------------------------------------------------------

def test_router_sends_exactly_the_seven_to_the_ring():
    """Of the 18 fetch_map variants at their tools' grids, the router as
    modelled (_route) sends exactly the seven to the ring form, the others
    to the two hot forms; the C entry launches the ring form for what the
    hot forms do not take, reporting each route, and the earlier row-split
    kernel is gone."""
    routes = {}
    for tool, names in probe.TOOL_VARIANTS.items():
        g = probe.Grid(16 if tool in ("stage_time", "grid_floor_probe")
                       else 4, 8, 4)
        for name in names:
            v = probe.VARIANTS[name]
            if v.kernel == "fetch_map":
                routes[name] = _route(v, g)
    assert len(routes) == 18
    assert sorted(n for n, r in routes.items() if r == "ring") == sorted(RING)
    assert {r for n, r in routes.items() if n not in RING} == {"direct",
                                                               "planar"}
    # the vector path compiled for the five ring variants that form output
    # (the two const0 ones store zeros), map_any for any other form
    for inst in ("<true, 4, MAP_COPY>", "<false, 4, MAP_COPY>",
                 "<false, 8, MAP_ZERO>", "<true, 0, MAP_COPY>",
                 "<false, 0, MAP_COPY>"):
        assert f"probe_fetch_map{inst}" in SRC
    assert ("cells < sms ? cells : sms, fm_smem(a.sb, a.nslots, a.head), "
            "s, args,") in SRC
    assert "ROWS * a.in[0].row_vecs()" not in SRC   # the row-split kernel's
    assert "touch_share" not in SRC and "constexpr int ROWS " not in SRC
    # the hot forms' conditions, as _route models them
    assert "if (nin == 1 && rep == 1 && xg == b.cols && op != MAP_CONST0)" \
        in SRC
    assert "a.out.rows % PLANAR_ROWS == 0 && b.cols % 8 == 0) {" in SRC
    # each launch reports its route, in probe._ROUTE_NAMES' order
    enum = re.search(r"enum \{ (ROUTE_\w+ = \d+(?:, ROUTE_\w+ = \d+)*) \};",
                     SRC).group(1)
    codes = {name[6:].lower(): int(k) for name, k in
             re.findall(r"(ROUTE_\w+) = (\d+)", enum)}
    assert [codes[r] for r in probe._ROUTE_NAMES] == [0, 1, 2]
    for r in ("DIRECT", "PLANAR", "RING"):
        assert f"if (route != nullptr) *route = ROUTE_{r};" in SRC


def test_wrapper_counts_the_route_the_entry_reports(monkeypatch):
    """The fetch_map wrapper counts each launch under MAP_ROUTES by what the
    C entry writes to its route argument (the router lives in C alone; a
    fake entry stands in for the card here), not by a decision of its own;
    the other kernels pass no route; reset_launches clears the counts."""
    reported = []

    class Entry:
        def __call__(self, *args):
            ref = args[-2]   # the route, before the stream
            ref._obj.value = reported[-1]
            return 0

    class Lib:
        w2x_probe_fetch_map = Entry()

    monkeypatch.setattr(probe, "_lib", lambda name="probe": Lib())
    monkeypatch.setattr(probe, "_check",
                        lambda *a, **k: torch.device("cuda"))

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    probe.reset_launches()
    v, g = probe.VARIANTS["xonly"], ODD_GRID
    args = probe.make_inputs(v, g, 0, "cpu")
    o = probe.out_spec(v.out, g)
    out = torch.empty(o.shape(g), dtype=probe._DTYPES[o.dtype])
    _, launch = probe._prepare(v, g, args, out)
    for code in (2, 0, 2, 1):
        reported.append(code)
        launch()
    assert probe.MAP_ROUTES == {"direct": 1, "planar": 1, "ring": 2}
    assert probe.LAUNCHES["fetch_map"] == 4
    cargs = probe._c_args(v, g, args, out)
    assert len(cargs) == len(probe._ARGTYPES["w2x_probe_fetch_map"]) - 1
    assert cargs[-1] is None   # no route asked: the entry writes none
    probe.reset_launches()
    assert set(probe.MAP_ROUTES.values()) == {0}


def test_constants_match_the_source():
    """The walk's geometry is the kernel's, and the ring and head buffer
    fit a block's shared memory, in both geometries."""
    c = FM
    assert c["FM_THREADS"] == 32 * c["FM_WARPS"] + 32
    assert c["FM_SMEM"] == 232448   # an H100 block's dynamic shared memory
    smem4 = (c["FM_SLOTS_4"] * c["FM_SLOT"] + 2 * c["FM_HEAD"]
             + 8 * (2 * c["FM_SLOTS_4"] + 4))
    smem1 = c["FM_SLOTS_1"] * c["FM_SLOT"] + 8 * (2 * c["FM_SLOTS_1"] + 4)
    assert max(smem1, smem4) <= c["FM_SMEM"]
    for name, g in WIDE:
        v = probe.VARIANTS[name]
        bs = [probe.block(k, v.array, g) for k in v.ins]
        sb, slots, head, _ = _geometry([b.cols * b.lanes * 2 for b in bs],
                                       [b.rows for b in bs])
        assert not head and slots * sb + 8 * (2 * slots + 4) <= c["FM_SMEM"]
    assert "a.nslots = (FM_SMEM - fm_smem(0, 0, false)) / (a.sb + 16);" \
        in SRC


def test_geometry_takes_every_input_the_row_split_kernel_took():
    """The earlier row-split kernel took any blocks whose rows it staged (4 rows
    of the tile and of the right stripe, row 0 of the lower and diagonal
    stripes) in a block's shared memory: 4 (rb0 + rb1) + rbl + rbd <=
    FM_SMEM. The ring form's geometry takes each of them, over block rows
    from one 16-byte vector to the limit, with 1 to 64 stripe rows; the
    entry refuses a row wider than FM_SMEM and a block row of no bytes."""
    sizes = [16, 512, 4096, 16 * 1024, 16 * 1024 + 16, 36 * 1024, 57 * 1024,
             100 * 1024, 200 * 1024]
    took = 0
    for rb0 in sizes:
        for rb1 in (0, 16, 512, 4096):
            for rbl in sizes:
                for rbd in (16, 512, 32 * 1024):
                    if 4 * (rb0 + rb1) + rbl + rbd > FM["FM_SMEM"]:
                        continue
                    for lrows in (1, 8, 64):
                        if rb1:   # four blocks
                            geo = _geometry([rb0, rb1, rbl, rbd],
                                            [64, 64, lrows, lrows])
                        else:
                            geo = _geometry([rb0], [64])
                        assert geo is not None, (rb0, rb1, rbl, rbd, lrows)
                        sb, slots, head, rpc = geo
                        assert slots >= 1 and rpc >= 1
                        assert sb >= rb0 + rb1 and (not rb1 or head
                                                    or sb >= max(rbl, rbd))
                        took += 1
    assert took > 500
    assert _geometry([FM["FM_SMEM"] + 16], [8]) is None
    assert _geometry([4096, 0, 4096, 512], [8, 8, 8, 8]) is None


# --- the walk, emulated ------------------------------------------------------

@pytest.mark.parametrize("g,sms", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("name", RING)
def test_walk_lands_every_row_and_writes_every_vector_once(name, g, sms):
    """Every block row that a BlockSpec names lands once a cell, whole, in
    its slot or half of the head buffer; every output vector is written
    once; the output built from the staged bytes is fetch_map_plain's, bit
    for bit."""
    v = probe.VARIANTS[name]
    assert _route(v, g) == "ring"
    x = _inputs(v, g, 3)
    out, writes, landed = _emulate(v, g, x, sms)
    want = {(kb, c, r) for kb, k in enumerate(v.ins) for c in range(g.cells)
            for r in range(probe.block(k, v.array, g).rows)}
    assert set(landed) == want and set(landed.values()) == {1}
    assert (writes == 1).all()
    got = _assemble(out, v, g)
    ref = probe.fetch_map_plain(v, g, x)
    assert probe.compare(got, ref)[2]


@pytest.mark.parametrize("name,g", WIDE, ids=WIDE_IDS)
def test_wide_geometry_lands_every_row_and_writes_every_vector_once(name, g):
    """Rows wider than a slot (tc 512 and 1024) or stripes wider than the
    head buffer (tc 256), at grids no tool runs: the wide geometry (slots as
    wide as the widest row, the stripes streamed through the ring after the
    tile and their row 0 read from device memory) still lands every block
    row once a cell and writes every output vector once, and its output is
    fetch_map_plain's, bit for bit, over four blocks."""
    v = probe.VARIANTS[name]
    assert _route(v, g) == "ring"
    walk = _walk(v, g, 4)
    assert not walk[0][0]["head_on"] and walk[0][0]["sb"] >= FM["FM_SLOT"]
    assert bool(walk[0][0]["passes"]) == (len(v.ins) == 4)
    x = _inputs(v, g, 4)
    out, writes, landed = _emulate(v, g, x, 4)
    want = {(kb, c, r) for kb, k in enumerate(v.ins) for c in range(g.cells)
            for r in range(probe.block(k, v.array, g).rows)}
    assert set(landed) == want and set(landed.values()) == {1}
    assert (writes == 1).all()
    got = _assemble(out, v, g)
    assert probe.compare(got, probe.fetch_map_plain(v, g, x))[2]


@pytest.mark.parametrize("name", ["lane16_x4", "lane128_x4", "xonly"])
def test_sum_order_is_the_plain_versions(name):
    """The four-block variants' f32 sums are taken as ((a + b) + c) + d,
    fetch_map_plain's order: on these inputs another order (a + (b + (c +
    d))) rounds differently, so the bit-equality above holds the order."""
    v, g = probe.VARIANTS[name], ODD_GRID
    x = _inputs(v, g, 5)
    bs = [probe.block(k, v.array, g) for k in v.ins]
    o = probe.out_spec(v.out, g)
    xs, lanes = o.xg // v.rep, o.lg
    a, b, c, d = (probe.cells(x, bk, g).float() for bk in bs)
    a, b = a[..., :xs, :lanes], b[..., :, 0:1, :lanes]
    c, d = c[..., 0:1, :xs, :lanes], d[..., 0:1, 0:1, :lanes]
    fwd = ((a + b) + c) + d
    rev = a + (b + (c + d))
    assert not torch.equal(fwd.to(torch.bfloat16), rev.to(torch.bfloat16))
    ref = probe.fetch_map_plain(v, g, x)
    got = _assemble(_emulate(v, g, x, 4)[0], v, g)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("g,sms", GRIDS, ids=GRID_IDS)
def test_cells_dealt_in_order(g, sms):
    """Cell blockIdx.x + k gridDim.x on min(cells, sms) blocks: every cell
    once; the cells of step k are consecutive; the head buffer's half is
    k & 1 (a cell's stripes land while the cell before is read)."""
    walk = _walk(probe.VARIANTS["xonly"], g, sms)
    assert len(walk) == min(g.cells, sms)
    flat = [(n * g.ny + i) * g.nx + j for cells in walk
            for n, i, j in (cw["cell"] for cw in cells)]
    assert sorted(flat) == list(range(g.cells))
    for k in range(max(map(len, walk))):
        step = [(lambda n, i, j: (n * g.ny + i) * g.nx + j)(*cells[k]["cell"])
                for cells in walk if len(cells) > k]
        assert step == list(range(k * len(walk), k * len(walk) + len(step)))
    assert all(cw["head"][0] == k % 2 for cells in walk
               for k, cw in enumerate(cells))
    assert SRC.count("for (int k = 0, c = blockIdx.x;") == 2


@pytest.mark.parametrize("name", ["lane16_x4", "lane128_x4", "xonly"])
def test_stripes_land_at_their_neighbours_steps(name):
    """At the JAX grid (one cell a block, all in flight at once): the right
    stripe's row r lands at the ring step at which the cell to the right
    lands its own tile row r (the same bytes), and the lower and diagonal
    stripes land at the cell's first step, while the cells below and below
    right land the same rows as their first tile rows: one fetch through L2
    serves both."""
    v, g = probe.VARIANTS[name], JAX_GRID
    walk = {cw["cell"]: cw for cells in _walk(v, g)
            for cw in cells}
    rpc = next(iter(walk.values()))["rpc"]
    first = -(-8 // rpc)   # the slots that hold tile rows 0-7
    for (n, i, j), cw in walk.items():
        for t, _, r0, nr, copies in cw["slots"]:
            rows = {r for kb, r, _ in copies if kb == 1}
            assert rows == set(range(r0, r0 + nr))   # with the tile rows
            if j + 1 < g.nx:   # the right cell reads them at the same step
                right = walk[(n, i, j + 1)]["slots"]
                assert right[t][2:4] == (r0, nr)
        if i + 1 < g.ny:
            below = walk[(n, i + 1, j)]["slots"]
            assert {r for s in below[:first] for kb, r, _ in s[4]
                    if kb == 0} >= set(range(8))
            assert [kb for kb, _, _ in cw["head"][1]] == [2] * 8 + [3] * 8
