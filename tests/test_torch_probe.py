"""The data-movement probes (waifu2x_torch/ops/probe.py) on the CPU against
the JAX tools' own kernels.

The JAX scripts (tools/stage_time.py, grid_floor_probe.py, dma_probe.py,
dma_probe2.py, dma_probe3.py) run their probes when imported, so each
pallas_call site's body and BlockSpecs are restated here from the cited
file:line, at a small grid, and run in Pallas interpret mode on seeded numpy
inputs. The port's plain version of every variant is held to the JAX body
bit for bit. cin9mm (nine f32 products) and grid_floor's 4-fetch (3 x tr x
tc lane-0 terms) sum in another order than the JAX body: their inputs are
drawn as k / 256, so that every sum is exact in any order, as
ops/probe.make_inputs draws them for the card. The two dma_probe2.py bodies
that do not
trace are asserted to raise in JAX and held to their plain version (zeros).
The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py (phase 18)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_torch.ops import probe
from waifu2x_torch.tools import dma_probe, grid_floor_probe, stage_time

torch.set_num_threads(2)

B, NY, NX, TR, TC = 2, 2, 2, 16, 32
G = probe.Grid(B, NY, NX, TR, TC)
H16, W16 = (NY + 1) * TR, (NX + 1) * TC
WD = W16 * 16 // 128
CB, RB = TC // 16, TR // 8
BF = jnp.bfloat16


def _spec(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _call(body, in_specs, out_spec, out_shape, *args, scratch=()):
    return pl.pallas_call(body, grid=(B, NY, NX), in_specs=in_specs,
                          out_specs=out_spec, out_shape=out_shape,
                          scratch_shapes=list(scratch), interpret=True)(*args)


def _draw(rng, shape, exact: bool) -> np.ndarray:
    """Uniform [0, 1), or k / 256 for k = 0..255 where sums must be exact."""
    if exact:
        return (rng.integers(0, 256, shape) / 256).astype(np.float32)
    return rng.random(shape, np.float32)


def _inputs(v: probe.Variant, seed: int = 0):
    """Seeded numpy inputs for both sides: (JAX args, port args)."""
    rng = np.random.default_rng(seed)
    jargs, targs = {}, {}
    if v.array is not None:
        x = jnp.asarray(_draw(rng, probe.array_shape(v.array, G),
                              v.name in probe.SUM_VARIANTS)).astype(BF)
        jargs["x"] = x
        targs["x"] = torch.from_numpy(
            np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    if v.seed:
        jargs["seed"] = jnp.ones((1, 8, 128), jnp.float32)
        targs["seed"] = torch.ones((1, 8, 128), dtype=torch.float32)
    if v.kernel == "l1_mm":
        w = jnp.asarray(_draw(rng, (9, 128), True)).astype(BF)
        jargs["w"] = w
        targs["w"] = torch.from_numpy(
            np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    return jargs, targs


def _bits(a):
    a = np.asarray(a)
    itype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
    return a.view(itype)


def _hold(name: str, jax_fn):
    """Run the restated JAX body and the port's plain version (through the
    wrapper, which takes it for CPU tensors) on the same inputs."""
    v = probe.VARIANTS[name]
    jargs, targs = _inputs(v)
    ref = jax_fn(**jargs)
    got = probe.run(v, G, targs, device="cpu")
    assert tuple(got.shape) == tuple(ref.shape)
    if got.dtype == torch.bfloat16:
        ref_np = np.array(ref.astype(jnp.float32))
        got_np = got.float().numpy()
    else:
        ref_np, got_np = np.array(ref), got.numpy()
    assert got_np.dtype == ref_np.dtype
    if got.dtype == torch.bfloat16:
        got_np = got.view(torch.int16).numpy().view(np.uint16)
        ref_np = np.array(jax.lax.bitcast_convert_type(ref, jnp.uint16))
    np.testing.assert_array_equal(_bits(got_np), _bits(ref_np))
    return got


# --- tools/stage_time.py ----------------------------------------------------
SSPEC = _spec((1, 8, 128), lambda n, i, j: (0, 0, 0))
XA16 = _spec((1, TR, TC, 16), lambda n, i, j: (n, i, j, 0))
XR = _spec((1, TR, 16, 16), lambda n, i, j: (n, i, (j + 1) * CB, 0))
XB_ = _spec((1, 8, TC, 16), lambda n, i, j: (n, (i + 1) * RB, j, 0))
XD_ = _spec((1, 8, 16, 16), lambda n, i, j: (n, (i + 1) * RB, (j + 1) * CB, 0))
ODENSE = _spec((1, TR, 4 * TC), lambda n, i, j: (n, i, j))
OSHAPE = jax.ShapeDtypeStruct((B, NY * TR, NX * 4 * TC), BF)
XA9 = _spec((1, TR, TC, 9), lambda n, i, j: (n, i, j, 0))


def test_stage_time_82_c4():
    def w4(s, out):
        out[0] = (jnp.zeros((TR, TC, 4), jnp.float32) + s[0, 0, 0]).astype(BF)

    _hold("c4", lambda seed: _call(
        w4, [SSPEC], _spec((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
        jax.ShapeDtypeStruct((B, NY * TR, NX * TC, 4), BF), seed))


def test_stage_time_95_cd():
    def wd(s, out):
        out[0] = (jnp.zeros((TR, 4 * TC), jnp.float32) + s[0, 0, 0]).astype(BF)

    _hold("cd", lambda seed: _call(wd, [SSPEC], ODENSE, OSHAPE, seed))


def _w4f(s, out):
    out[0] = jnp.zeros((TR, TC, 4), jnp.float32) + s[0, 0, 0]


def _w16f(s, out):
    out[0] = jnp.zeros((TR, TC, 16), jnp.float32) + s[0, 0, 0]


def _w16u(s, out):
    out[0] = (jnp.zeros((TR, TC, 16), jnp.float32)
              + s[0, 0, 0]).astype(jnp.int32).astype(jnp.uint8)


@pytest.mark.parametrize("name,oshape,odtype,body", [
    ("out4f32", (TR, TC, 4), jnp.float32, _w4f),
    ("out16f32", (TR, TC, 16), jnp.float32, _w16f),
    ("out16u8", (TR, TC, 16), jnp.uint8, _w16u)])
def test_stage_time_113_mkout(name, oshape, odtype, body):
    def mkout(seed):
        return _call(body, [SSPEC], _spec(
            (1,) + oshape, (lambda n, i, j: (n, i, j, 0)) if len(oshape) == 3
            else (lambda n, i, j: (n, i, j))), jax.ShapeDtypeStruct(
            (B, NY * oshape[0], NX * oshape[1]) + oshape[2:], odtype), seed)

    _hold(name, mkout)


def test_stage_time_172_cin1():
    def bin1(xa, out):
        t = jnp.max(xa[0][0:8, 0:8, :].astype(jnp.float32))
        out[0] = (jnp.zeros((TR, 4 * TC), jnp.float32) + t).astype(BF)

    _hold("cin1", lambda x: _call(bin1, [XA16], ODENSE, OSHAPE, x))


def test_stage_time_187_cin4():
    def bin4(xa, xb, xc, xd, out):
        t = (jnp.max(xa[0][0:8, 0:8, :].astype(jnp.float32))
             + jnp.max(xb[0][0:8, 0:8, :].astype(jnp.float32))
             + jnp.max(xc[0][0:8, 0:8, :].astype(jnp.float32))
             + jnp.max(xd[0][0:8, 0:8, :].astype(jnp.float32)))
        out[0] = (jnp.zeros((TR, 4 * TC), jnp.float32) + t).astype(BF)

    _hold("cin4", lambda x: _call(bin4, [XA16, XR, XB_, XD_], ODENSE, OSHAPE,
                                  x, x, x, x))


def test_stage_time_203_ccat():
    def bcat(xa, out):
        t = xa[0][:, :, 0:4].astype(jnp.float32) * 0.5
        v = jnp.concatenate([t[:, :, 0], t[:, :, 1], t[:, :, 2], t[:, :, 3]],
                            axis=-1)
        out[0] = v.astype(BF)

    _hold("ccat", lambda x: _call(bcat, [XA16], ODENSE, OSHAPE, x))


def test_stage_time_220_cin9():
    def bin9(xa, out):
        t = jnp.max(xa[0][0:8, 0:8, :].astype(jnp.float32))
        out[0] = (jnp.zeros((TR, 4 * TC), jnp.float32) + t).astype(BF)

    _hold("cin9", lambda x: _call(bin9, [XA9], ODENSE, OSHAPE, x))


def test_stage_time_241_cin9mm():
    def bin9mm(xa, w, out, x1):
        x1[...] = jax.lax.dot_general(
            xa[0], w[...], dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(BF)
        out[0] = jnp.concatenate(
            [x1[:, :, 0], x1[:, :, 1], x1[:, :, 2], x1[:, :, 3]], axis=-1)

    l1spec = _spec((9, 128), lambda n, i, j: (0, 0))
    got = _hold("cin9mm", lambda x, w: _call(
        bin9mm, [XA9, l1spec], ODENSE, OSHAPE, x, w,
        scratch=[pltpu.VMEM((TR, TC, 128), BF)]))
    assert got.float().abs().min() > 0   # sums of positive products


# --- tools/grid_floor_probe.py:100 --------------------------------------------
def _blk(di, dj):
    return _spec((1, TR, TC, 16),
                 lambda n, i, j, di=di, dj=dj: (n, i + di, j + dj, 0))


def _gf_body0(out):
    out[0] = jnp.full((TR, TC, 4), 1.0, out.dtype)


def _gf_body1(xa, out):
    out[0] = xa[0][:, :, 0:4]


def _gf_body4(xa, xb, xc, xd, out):
    val = xa[0][:, :, 0:4].astype(jnp.float32)
    s = jnp.float32(0)
    for ref in (xb, xc, xd):
        s = s + jnp.sum(ref[0][:, :, 0:1].astype(jnp.float32))
    out[0] = (val + s).astype(out.dtype)


@pytest.mark.parametrize("name,body,nops", [
    ("store-only", _gf_body0, 0), ("1-fetch", _gf_body1, 1),
    ("4-fetch", _gf_body4, 4)])
def test_grid_floor_probe_100(name, body, nops):
    def f(x=None):
        return _call(body, [_blk(0, 0), _blk(0, 1), _blk(1, 0),
                            _blk(1, 1)][:nops],
                     _spec((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
                     jax.ShapeDtypeStruct((B, NY * TR, NX * TC, 4), BF),
                     *((x,) * nops))

    _hold(name, f)


# --- tools/dma_probe.py -------------------------------------------------------
O4 = (_spec((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
      jax.ShapeDtypeStruct((B, NY * TR, NX * TC, 4), BF))


def _d1_body4(xa, xb, xc, xd, out):
    t = (xa[0][0:TR, 0:TC, 0:4].astype(jnp.float32)
         + xb[0][:, 0:1, 0:4].astype(jnp.float32)
         + xc[0][0:1, :, 0:4].astype(jnp.float32)
         + xd[0][0:1, 0:1, 0:4].astype(jnp.float32))
    out[0] = t.astype(BF)


def _d1_body1(xa, out):
    out[0] = xa[0][:, :, 0:4]


def _d1_bodyd(xa, out):
    out[0] = xa[0][:, 0:TC // 8, 0:4].astype(jnp.float32).repeat(
        8, axis=1).astype(BF)


def _d1_bodyd4(xa, xb, xc, xd, out):
    t = (xa[0][0:TR, 0:TC // 8, 0:4].astype(jnp.float32)
         + xb[0][:, 0:1, 0:4].astype(jnp.float32)
         + xc[0][0:1, :, 0:4].astype(jnp.float32)
         + xd[0][0:1, 0:1, 0:4].astype(jnp.float32))
    out[0] = t.repeat(8, axis=1).astype(BF)


CBD = TC // 8 // 2
D1_SPECS = {
    "lane16_x4": [XA16, XR, XB_, XD_],
    "lane16_x1": [XA16],
    "lane128": [_spec((1, TR, TC // 8, 128), lambda n, i, j: (n, i, j, 0))],
    "lane128_x4": [
        _spec((1, TR, TC // 8, 128), lambda n, i, j: (n, i, j, 0)),
        _spec((1, TR, 2, 128), lambda n, i, j: (n, i, (j + 1) * CBD, 0)),
        _spec((1, 8, TC // 8, 128), lambda n, i, j: (n, (i + 1) * RB, j, 0)),
        _spec((1, 8, 2, 128),
              lambda n, i, j: (n, (i + 1) * RB, (j + 1) * CBD, 0))],
}


@pytest.mark.parametrize("name,body", [
    ("lane16_x4", _d1_body4), ("lane16_x1", _d1_body1),
    ("lane128", _d1_bodyd), ("lane128_x4", _d1_bodyd4)])
def test_dma_probe_55(name, body):
    specs = D1_SPECS[name]
    _hold(name, lambda x: _call(body, specs, *O4, *([x] * len(specs))))


def test_dma_probe_157_raw2d():
    def bodyr(xa, out):
        t = xa[0].astype(jnp.float32)
        out[0] = jnp.stack([t, t, t, t], axis=-1).astype(BF)

    _hold("raw2d", lambda x: _call(
        bodyr, [_spec((1, TR, TC), lambda n, i, j: (n, i, j))], *O4, x))


# --- tools/dma_probe2.py:50 ---------------------------------------------------
O128 = (_spec((1, TR, 4, 128), lambda n, i, j: (n, i, j, 0)),
        jax.ShapeDtypeStruct((B, NY * TR, NX * 4, 128), BF))
O2D = (_spec((1, TR, TC), lambda n, i, j: (n, i, j)),
       jax.ShapeDtypeStruct((B, NY * TR, NX * TC), BF))
O16C = (_spec((1, TR, TC, 16), lambda n, i, j: (n, i, j, 0)),
        jax.ShapeDtypeStruct((B, NY * TR, NX * TC, 16), jnp.uint8))
XAD = _spec((1, TR, WD // NX, 128), lambda n, i, j: (n, i, j, 0))
XAR = _spec((1, TR, TC), lambda n, i, j: (n, i, j))


def _d2_w4(out):
    out[0] = jnp.zeros((TR, TC, 4), BF)


def _d2_w128(out):
    out[0] = jnp.zeros((TR, 4, 128), BF)


def _d2_w2d(out):
    out[0] = jnp.zeros((TR, TC), BF)


def _d2_b16(xa, out):
    out[0] = xa[0][:, 0:4, :].astype(jnp.float32).astype(BF) * 0


def _d2_b128(xa, out):
    out[0] = xa[0][:, 0:4, :] * 0


def _d2_braw(xa, out):
    t = xa[0]
    out[0] = jnp.stack([t[:, 0:4]] * 32, axis=-1).reshape(TR, 4, 128) * 0


def _d2_b16u(xa, out):
    out[0] = (xa[0].astype(jnp.float32) * 0).astype(jnp.int32).astype(
        jnp.uint8)


D2 = {"out4": ([], O4, _d2_w4), "out128": ([], O128, _d2_w128),
      "out2d": ([], O2D, _d2_w2d), "in16+o128": ([XA16], O128, _d2_b16),
      "in128+o128": ([XAD], O128, _d2_b128),
      "raw+o128": ([XAR], O128, _d2_braw),
      "in16+o16c": ([XA16], O16C, _d2_b16u)}


@pytest.mark.parametrize("name", list(D2))
def test_dma_probe2_50(name):
    in_specs, (ospec, oshape), body = D2[name]

    def f(x=None):
        return _call(body, in_specs, ospec, oshape, *([x] * len(in_specs)))

    v = probe.VARIANTS[name]
    if v.traces:
        _hold(name, f)
        return
    # the body writes a value of another shape into the output block: JAX
    # refuses to trace it, at any size; the port writes the zero block
    jargs, targs = _inputs(v)
    with pytest.raises((ValueError, TypeError)):
        f(**jargs)
    got = probe.run(v, G, targs, device="cpu")
    assert tuple(got.shape) == oshape.shape and got.dtype == torch.bfloat16
    assert not got.float().abs().max()


# --- tools/dma_probe3.py:54 ---------------------------------------------------
def _mk_y(xa):
    t = xa[0][:, :, 0:4].astype(jnp.float32)
    return t * 0.5 + 1.0


def _d3_y4(xa, out):
    out[0] = _mk_y(xa).astype(BF)


def _d3_y512r(xa, out):
    out[0] = _mk_y(xa).astype(BF).reshape(TR, TC * 4)


def _d3_y512n(xa, out):
    t = xa[0][:, :, 0:4].astype(jnp.float32)
    v = jnp.concatenate([t[:, :, 0], t[:, :, 1], t[:, :, 2], t[:, :, 3]],
                        axis=-1)
    out[0] = v.astype(BF)


def _d3_u8(xa, out):
    t = xa[0].astype(jnp.float32) * 255.0
    q = jnp.clip(jnp.round(t), 0, 255).astype(jnp.int32)
    out[0] = q.astype(jnp.uint8)


def _d3_u8r(xa, out):
    t = xa[0].astype(jnp.float32) * 255.0
    q = jnp.clip(jnp.round(t), 0, 255).astype(jnp.int32)
    out[0] = q.astype(jnp.uint8).reshape(TR, TC * 16)


Y512 = (_spec((1, TR, TC * 4), lambda n, i, j: (n, i, j)),
        jax.ShapeDtypeStruct((B, NY * TR, NX * TC * 4), BF))
D3 = {"y4": (O4, _d3_y4), "y512r": (Y512, _d3_y512r),
      "y512n": (Y512, _d3_y512n), "u8_16": (O16C, _d3_u8),
      "u8_2048r": ((_spec((1, TR, TC * 16), lambda n, i, j: (n, i, j)),
                    jax.ShapeDtypeStruct((B, NY * TR, NX * TC * 16),
                                         jnp.uint8)), _d3_u8r)}


@pytest.mark.parametrize("name", list(D3))
def test_dma_probe3_54(name):
    (ospec, oshape), body = D3[name]
    _hold(name, lambda x: _call(body, [XA16], ospec, oshape, x))


def test_reshaped_forms_are_the_same_bytes():
    """y512r and u8_2048r store what y4 and u8_16 store, byte for byte."""
    for a, b in (("y4", "y512r"), ("u8_16", "u8_2048r")):
        va, vb = probe.VARIANTS[a], probe.VARIANTS[b]
        _, targs = _inputs(va)
        ra, rb = probe.run(va, G, targs), probe.run(vb, G, targs)
        assert torch.equal(ra.reshape(-1), rb.reshape(-1))


# --- the table, the wrappers, the tools ----------------------------------------
def test_variants_cover_the_13_sites():
    """The 13 sites of stage_time, grid_floor_probe and dma_probe 1-3, and
    the two fetches of the truncation probes (tests/test_torch_trunc.py
    holds those two against their JAX bodies)."""
    sites = {v.site for v in probe.VARIANTS.values()}
    assert sites == {
        "tools/stage_time.py:82", "tools/stage_time.py:95",
        "tools/stage_time.py:113", "tools/stage_time.py:172",
        "tools/stage_time.py:187", "tools/stage_time.py:203",
        "tools/stage_time.py:220", "tools/stage_time.py:241",
        "tools/grid_floor_probe.py:100", "tools/dma_probe.py:55",
        "tools/dma_probe.py:157", "tools/dma_probe2.py:50",
        "tools/dma_probe3.py:54", "tools/fused_strip_probe.py:134",
        "tools/l14_probe.py:145"}
    listed = [n for names in probe.TOOL_VARIANTS.values() for n in names]
    assert sorted(listed) == sorted(probe.VARIANTS)
    assert {v.kernel for v in probe.VARIANTS.values()} == {
        "store", "fetch_map", "fetch_reduce", "l1_mm"}


def test_traffic_counts_every_blockspec():
    """Bytes by BlockSpecs: lane16_x4 fetches the (tr, tc, 16) tile, the
    (tr, 16, 16) and (8, tc, 16) stripes and the (8, 16, 16) corner, and
    stores the (tr, tc, 4) block, per cell."""
    per_cell = (TR * TC + TR * 16 + 8 * TC + 8 * 16) * 16 * 2 + TR * TC * 8
    assert probe.traffic_bytes(probe.VARIANTS["lane16_x4"], G) == (
        per_cell * G.cells)
    assert probe.traffic_bytes(probe.VARIANTS["c4"], G) == (
        (TR * TC * 8 + 4096) * G.cells)


def test_distinct_bytes_count_overlaps_once():
    """A cell's right, lower and diagonal blocks are its neighbours' tiles
    (4-fetch) or parts of them (the stripes): the distinct input bytes are
    the union of the blocks; without overlap they are the BlockSpecs'."""
    out = TR * TC * 4 * 2 * G.cells
    union = B * (NY + 1) * TR * (NX + 1) * TC * 16 * 2
    assert probe.distinct_bytes(probe.VARIANTS["4-fetch"], G) == union + out
    stripes = B * (NY * TR + 8) * (NX * TC + 16) * 16 * 2
    assert probe.distinct_bytes(probe.VARIANTS["lane16_x4"], G) == (
        stripes + out)
    for name in ("lane16_x1", "cin1", "y512n", "in128+o128"):
        v = probe.VARIANTS[name]
        assert probe.distinct_bytes(v, G) == probe.traffic_bytes(v, G)


def test_wrappers_check_their_arguments():
    v = probe.VARIANTS["lane16_x1"]
    _, targs = _inputs(v)
    with pytest.raises(ValueError, match="contiguous"):
        probe.run(v, G, {"x": targs["x"].float()})
    with pytest.raises(ValueError, match="takes"):
        probe.run(v, G, {})
    with pytest.raises(ValueError, match="out must be"):
        probe.run(v, G, targs, out=torch.empty(3))
    with pytest.raises(ValueError, match="powers of two"):
        g48 = probe.Grid(1, 1, 1, 16, 48)
        probe.run(v, g48, {"x": torch.zeros(probe.array_shape("x16", g48),
                                            dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="tile"):
        probe.run(v, probe.Grid(1, 1, 1, 12, 32), {"x": torch.zeros(
            probe.array_shape("x16", probe.Grid(1, 1, 1, 12, 32)),
            dtype=torch.bfloat16)})


def test_cpu_wrappers_launch_nothing():
    probe.reset_launches()
    for name, v in probe.VARIANTS.items():
        _, targs = _inputs(v)
        out = probe.run(v, G, targs, device="cpu")
        assert torch.equal(out, probe.run(v, G, targs, out=torch.empty_like(
            out), device="cpu"))
    assert not any(probe.LAUNCHES.values())


def test_measure_on_cpu_reports_no_device_time():
    r = probe.measure(probe.VARIANTS["cin4"], G, torch.device("cpu"), 1)
    assert r["ok"] and r["ms"] is None and r["rate_gbs"] is None
    assert r["eager_ms"] is None and r["ffma_floor_ms"] is None
    assert r["bound_ms"] == r["distinct_bytes"] / probe.PEAK_BYTES * 1e3
    assert r["bound_by"] == "bytes"
    # cin9mm's bf16 products fit the tensor cores' rate: bound by its bytes;
    # the FFMA floor of the way the kernel computes them is printed apart
    mm = probe.measure(probe.VARIANTS["cin9mm"], G, torch.device("cpu"), 1)
    assert mm["flops"] == 2 * 9 * 128 * B * NY * NX * TR * TC
    assert mm["bound_by"] == "bytes" and mm["bound_ms"] == (
        mm["distinct_bytes"] / probe.PEAK_BYTES * 1e3)
    assert mm["ffma_floor_ms"] == mm["flops"] / probe.PEAK_F32_FLOPS * 1e3
    assert "not measured" in probe.format_row(r)
    assert "as FFMA" in probe.format_row(mm)


@pytest.mark.parametrize("name", probe.SUM_VARIANTS)
def test_exact_sums_make_one_dropped_term_visible(name):
    """On make_inputs' k / 256 inputs, a kernel that dropped a part of a
    sum (one row of a neighbour tile's lane 0, TC terms; one tap of the
    weight) would not equal the plain version: the bit-equal bar catches
    it. (A single lane-0 term of the 4-fetch is under its output's bf16
    resolution and changes no output: the function does not see it.)"""
    v = probe.VARIANTS[name]
    args = probe.make_inputs(v, G, 0, "cpu")
    ref = probe.plain(v, G, args)
    assert probe.compare(probe.plain(v, G, args), ref)[2]
    bad = {k: t.clone() for k, t in args.items()}
    if name == "4-fetch":
        bad["x"][0, TR, 0:TC, 0] = 0.0   # row 0 of cell (0, 0, 0)'s tile10
    else:
        bad["w"][8] = 0.0             # the last tap
    err, share, ok = probe.compare(probe.plain(v, G, bad), ref)
    assert not ok and share > 0


TINY = ["--device", "cpu", "--batch", "1", "--size", "32", "--tile", "16",
        "32", "--iters", "1"]


@pytest.mark.parametrize("tool,argv,names", [
    (stage_time, TINY + ["--stage_iters", "1"], "stage_time"),
    (grid_floor_probe, TINY, "grid_floor_probe"),
    (dma_probe, TINY, None)])
def test_tool_main_on_cpu(tool, argv, names, capsys):
    rows = []
    assert tool.main(argv, rows) == 0
    want = (probe.TOOL_VARIANTS[names] if names else
            sum((probe.TOOL_VARIANTS[f"dma_probe {k}"] for k in (1, 2, 3)),
                ()))
    assert [r["name"] for r in rows] == list(want)
    out = capsys.readouterr().out
    assert "no device time" in out and "FAILED" not in out
    if tool is stage_time:
        assert all(s in out for s in ("kernel", "tail", "step", "xcol"))


def test_tools_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dma_probe.main(["--round", "1"])
