"""B4's layer 7 as the JAX body's fold on the int8 layer 6's tile-major
planes (csrc/l7.cu with a tiling) on the CPU: the int8 stacks' plain
versions end in the fold of each tile, which is l7_fold_plain on the tile
batch placed at the image's cells, bit for bit; an emulation of the
kernel's walk (its strips, the persistent blocks' shares of rows, the write
of each cell at its image cell, the crop, the dense chunks and their pad
columns, the u8 form's U/V at the image cell) gives the plain version's
output bit for bit; layer 7 alone on the tiles (last_layer_tiles) in its
three forms; and which C entry every int8 stack call reaches (a fake
library stands in for the card). The int8 stacks against the JAX kernel in
interpret mode are tests/test_torch_l6.py's. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py (phase 26)."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from waifu2x_torch.models.srcnn import init_params
from waifu2x_torch.ops import stack

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]
# (image cells N x hl x wl, tile): a whole grid, a ragged one, a thin one
MAPS = [((1, 32, 32), (8, 16)), ((2, 27, 38), (8, 16)), ((1, 5, 300), (3, 5))]
MAP_IDS = ["32x32", "27x38", "5x300"]


@pytest.fixture(scope="module")
def sps():
    return {dt: stack.prep_params(init_params(3), dt, "cpu") for dt in DTYPES}


def _grid(hl, wl, tile):
    tr, tc = tile
    return tr, tc, -(-hl // tr), -(-wl // tc)


def _x6t(n, hl, wl, tile, dtype, seed):
    tr, tc, ny, nx = _grid(hl, wl, tile)
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, ny, nx, 2 * tr + 2, 2 * tc + 2, 128),
                      generator=gen).to(dtype)


def _tile_fold(x6t, sp):
    """l7_fold_plain on the tile batch -> Y f32 [N*ny*nx, tr, tc, 4]."""
    return stack.l7_fold_plain(x6t.reshape(-1, *x6t.shape[3:]),
                               stack._w7f(sp, x6t), sp[6][1])


# --- the plain versions ------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape,tile,noise", [
    ((1, 32, 32), (8, 16), False), ((2, 27, 38), (8, 16), False),
    ((1, 10, 18), (3, 5), True)], ids=["scale-32x32", "scale-27x38",
                                       "noise-10x18"])
def test_i8_stack_ends_in_the_tile_fold(sps, dtype, shape, tile, noise):
    """The int8 stack's plain version is layer 7 folded on each tile's
    plane (l7_fold_plain on the tile batch of l6_i8_layer's output) with
    each tile's cells placed at the image's, cropped: bit for bit."""
    sp = sps[dtype]
    y = torch.rand(shape, generator=torch.Generator().manual_seed(4)).to(
        dtype)
    if noise:
        got = stack.stack_noise_s2d(y, sp, l6_i8=True, tile=tile)
        hl, wl = shape[1] // 2, shape[2] // 2
    else:
        got = stack.stack_scale(y, sp, l6_i8=True, tile=tile)
        hl, wl = shape[1:]
    x6t, _ = stack.l6_i8_layer(stack.layer5_plane(y, sp, tile,
                                                  full_res=noise), sp, tile)
    n, ny, nx = x6t.shape[:3]
    tr, tc = tile
    yt = _tile_fold(x6t, sp)
    ref = torch.empty((n, ny * tr, nx * tc, 4))
    for p in range(n * ny * nx):
        img, ty, tx = p // (ny * nx), (p // nx) % ny, p % nx
        ref[img, ty * tr:(ty + 1) * tr, tx * tc:(tx + 1) * tc] = yt[p]
    assert got.shape == (n, hl, wl, 4) and got.dtype == dtype
    assert torch.equal(got, ref[:, :hl, :wl].to(dtype))
    assert torch.equal(stack.l7_tiles_plain(x6t, stack._w7f(sp, x6t),
                                            sp[6][1]), ref)


# --- the kernel's walk, emulated ---------------------------------------------

def _kernel_walk(n, hl, wl, tiling, ocols, cells, sms):
    """csrc/l7.cu's walk with a tiling, step by step: fold_args' strips and
    rows, block_rows' share of a grid of `sms` blocks, the Cursor, and
    l7_cell's test of each output cell -> the writes as an int array of
    (image, I, J, plane, i, j) rows, in the order the blocks make them."""
    tr, tc, ny, nx = tiling
    out = cells - 1
    wlast = max(tc, ocols - (nx - 1) * tc)
    nstrips = (wlast + cells - 2) // (cells - 1)
    rows = n * ny * nx * nstrips * tr
    blocks = min(rows, sms)
    per, extra = divmod(rows, blocks)
    writes = []
    for bid in range(blocks):
        u0 = bid * per + min(bid, extra)
        u1 = u0 + per + (1 if bid < extra else 0)
        u, row = u0, u0 % tr
        strip, pn, head = (u0 // tr) % nstrips, u0 // tr // nstrips, True
        while u < u1:
            if not head:
                tx, rest = pn % nx, pn // nx
                ty, img = rest % ny, rest // ny
                for col in range(out):
                    j = strip * out + col
                    i_img, j_img = ty * tr + row, tx * tc + j
                    if (j < (wlast if tx == nx - 1 else tc) and i_img < hl
                            and j_img < ocols):
                        writes.append((img, i_img, j_img, pn, row, j))
            if head:
                head = False
                continue
            u, row = u + 1, row + 1
            if row == tr:
                row, head, strip = 0, True, strip + 1
                if strip == nstrips:
                    strip, pn = 0, pn + 1
    return np.array(writes, dtype=np.int64).reshape(-1, 6)


@pytest.mark.parametrize("cells", [64, 32], ids=["bf16-tile", "f32-tile"])
@pytest.mark.parametrize("shape,tile", MAPS, ids=MAP_IDS)
@pytest.mark.parametrize("out", ["s2d", "dense", "u8"])
def test_kernel_tile_map_matches_the_plain_version(sps, shape, tile, out,
                                                   cells):
    """The emulated walk writes every image cell (and, dense, every pad
    column of the last chunk) exactly once, each from its own tile's cell,
    never a cell past a tile but the last column's pad; the output it builds
    from the tile batch's Y in each form is last_layer_tiles' plain version,
    bit for bit. Seven blocks, so that shares end mid-strip."""
    n, hl, wl = shape
    sp = sps[torch.float32]
    x6t = _x6t(n, hl, wl, tile, torch.float32, 8)
    tiling = _grid(hl, wl, tile)
    tr, tc, ny, nx = tiling
    dtc = stack._dense_tc(wl, None)
    ocols = -(-wl // dtc) * dtc if out == "dense" else wl
    w = _kernel_walk(n, hl, wl, tiling, ocols, cells, sms=7)
    img, ii, jj, pn, row, j = w.T
    # every written cell once, from the plane its image cell lies in
    keys = (img * hl + ii) * ocols + jj
    assert len(np.unique(keys)) == len(keys) == n * hl * ocols
    real = jj < wl
    tile_of = (img * ny + ii // tr) * nx + jj // tc
    assert (pn[real] == tile_of[real]).all()
    assert (row == ii % tr).all() and (j[real] == jj[real] % tc).all()
    assert (j[~real] >= 0).all() and (jj[j >= tc] >= wl).all()
    yt = _tile_fold(x6t, sp)
    yimg = torch.full((n, hl, wl, 4), float("nan"))
    r = torch.from_numpy(real)
    yimg[img[real], ii[real], jj[real]] = yt[pn[real], row[real], j[real]]
    assert not yimg.isnan().any()
    kw = {}
    if out == "u8":
        kw["uvp"] = torch.rand((n, hl, wl, 8),
                               generator=torch.Generator().manual_seed(9))
    want = stack.last_layer_tiles(x6t, sp, hl, wl, out=out, **kw)
    got = stack.last_out(yimg, out, torch.float32, kw.get("uvp"), dtc)
    if out == "dense":
        assert want[1] == got[1] == dtc
        want, got = want[0], got[0]
        # the walk's pad cells are the dense layout's zeros
        cols = np.arange(wl, ocols)
        assert len(cols) * n * hl == int((~r).sum())
        idx = ((cols // dtc) * 4 * dtc + cols % dtc)[:, None] + \
            dtc * np.arange(4)[None]
        assert not got[:, :, torch.from_numpy(idx.ravel())].any()
    assert torch.equal(got, want)


# --- layer 7 alone on the tiles ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape,tile", MAPS, ids=MAP_IDS)
def test_last_layer_tiles_forms(sps, dtype, shape, tile):
    """last_layer_tiles on CPU tensors: one Y in three forms (dense
    un-chunked equal to s2d bit for bit, its pad columns zero; u8 the
    colour map of the unrounded Y); the 9-tap sum of each tile
    (last_layer_plain's function) is the same function within 1e-5 in f32
    (another order of f32 sums) and one bf16 ulp in bf16; no launch is
    counted."""
    n, hl, wl = shape
    sp = sps[dtype]
    x6t = _x6t(n, hl, wl, tile, dtype, 10)
    stack.reset_launches()
    ys = stack.last_layer_tiles(x6t, sp, hl, wl)
    assert ys.shape == (n, hl, wl, 4) and ys.dtype == dtype
    yd, tc = stack.last_layer_tiles(x6t, sp, hl, wl, out="dense")
    assert torch.equal(stack.dense_to_s2d(yd, tc, hl, wl), ys)
    assert not yd.reshape(n, hl, -1, 4, tc).transpose(3, 4).reshape(
        n, hl, -1, 4)[:, :, wl:].any()
    uvp = torch.rand((n, hl, wl, 8),
                     generator=torch.Generator().manual_seed(3))
    u8 = stack.last_layer_tiles(x6t, sp, hl, wl, out="u8", uvp=uvp)
    ytf = stack.l7_tiles_plain(x6t, stack._w7f(sp, x6t), sp[6][1])
    assert torch.equal(u8, stack.last_out(ytf[:, :hl, :wl], "u8", dtype,
                                          uvp))
    nine = stack._tiles_image(stack.last_layer_plain(
        x6t.reshape(-1, *x6t.shape[3:]), *sp[6]), *x6t.shape[:3])
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * max(
        1.0, ys.float().abs().max().item())
    assert (nine[:, :hl, :wl].float() - ys.float()).abs().max().item() <= tol
    assert all(v == 0 for v in stack.L7_LAUNCHES.values())
    assert stack.LAUNCHES == 0


def test_last_layer_tiles_refuses_what_the_kernel_does_not_take(sps):
    sp = sps[torch.float32]
    x6t = _x6t(1, 9, 20, (8, 16), torch.float32, 11)
    with pytest.raises(ValueError, match="grid"):
        stack.last_layer_tiles(x6t, sp, 17, 20)        # past the grid
    with pytest.raises(ValueError, match="grid"):
        stack.last_layer_tiles(x6t, sp, 8, 20)         # a whole tile row off
    with pytest.raises(ValueError, match="x6t"):
        stack.last_layer_tiles(x6t[0], sp, 9, 20)
    with pytest.raises(ValueError, match="uvp"):
        stack.last_layer_tiles(x6t, sp, 9, 20, out="u8")
    with pytest.raises(TypeError, match="weights"):
        stack.last_layer_tiles(x6t.to(torch.bfloat16), sp, 9, 20)
    with pytest.raises(ValueError, match="zero-shift|out"):
        stack.last_layer_tiles(x6t, sp, 9, 20, out="taps")


# --- the dispatch of whole int8 stack calls ----------------------------------

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
@pytest.mark.parametrize("kind", ["scale", "noise", "dense", "fused_u8"])
def test_i8_stack_dispatch_reaches_the_fold(sps, fake_card, dtype, kind):
    """Every int8 stack call, in both types and every output form, ends in
    w2x_l7_fold with the tiling (tr, tc, ny, nx), the image's cells and
    the form, counted under L7_LAUNCHES["fold"] (bf16) or ["fold_f32"]
    (f32), and 7 launches are made (the tile maxima in layer 5's
    epilogue)."""
    sp = sps[dtype]
    n, h, w = 1, 20, 36
    hl, wl = (h // 2, w // 2) if kind == "noise" else (h, w)
    stack._launch(torch.zeros((n, h, w), dtype=dtype), sp, kind, None,
                  uvp=(torch.zeros((n, h, w, 8)) if kind == "fused_u8"
                       else None),
                  tc=32 if kind == "dense" else 0, form="i8", tile=(4, 16))
    names = [fn for fn, _ in fake_card]
    assert names[-1] == "w2x_l7_fold"
    assert len(names) == 7 == stack.LAUNCHES
    bf16 = dtype == torch.bfloat16
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16)}
    args = fake_card[-1][1]
    # (bf16, x6t, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
    #  tr, tc, ny, nx, zs, stream)
    assert args[0] == int(bf16)
    assert args[2] == (sp.w7f if bf16 else sp[6][0]).data_ptr()
    assert args[5:9] == (n, hl, wl, stack._OUT_MODES[kind])
    assert args[11] == (32 if kind == "dense" else 0)
    assert args[12:] == (4, 16, -(-hl // 4), -(-wl // 16), 0, 0)


@pytest.mark.parametrize("out", ["cell", "phase_taps"])
def test_i8_truncation_plain_takes_its_form(sps, out):
    """stack_scale_upto's plain version at upto 6 under int8 gives the form
    asked for, tile by tile: the same-cell taps (out="cell") or the
    unfolded partials of each cell's pixel (0, 0) (out="phase_taps"), each
    from l6_i8_layer's tile planes."""
    sp = sps[torch.float32]
    tile = (4, 8)
    y = torch.rand((1, 8, 16), generator=torch.Generator().manual_seed(12))
    got = stack.stack_scale_upto(y, sp, 6, l6_i8=True, tile=tile, out=out)
    x6t, _ = stack.l6_i8_layer(stack.layer5_plane(y, sp, tile), sp, tile)
    fn = stack._phase_taps_plain if out == "phase_taps" else stack._taps_plain
    ref = stack._tiles_image(fn(x6t.reshape(-1, *x6t.shape[3:]).permute(
        0, 3, 1, 2), sp[6][0], torch.float32), *x6t.shape[:3])
    assert got.shape == (1, 8, 16, 4)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
