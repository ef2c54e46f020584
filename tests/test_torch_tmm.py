"""The four-tap 128 -> 128 layer of tools/tmm_probe.py (ops/probe.py:tap_mm,
csrc/tmm.cu) on the CPU against the JAX tool's own kernels.

tools/tmm_probe.py runs its probes when imported, so its two pallas_call
sites, cch (:79, body_ch, channels in lanes) and cpos (:122, body_pos,
positions in lanes), are restated here from the cited lines at a grid of
(2, 2, 2) cells of (8, 16) and run in Pallas interpret mode. Inputs are
drawn as k / 16 (k = 0..15): every product is a multiple of 1/256 and a
512-term sum stays under 2^24 such units, so the f32 sums are exact in any
order and the port's plain version is held to each body bit for bit, as the
kernel is held to the plain version on the card (chip_smoke.py, phase 19).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_torch.ops import probe
from waifu2x_torch.tools import tmm_probe

torch.set_num_threads(2)

B, NY, NX, TR, TC = 2, 2, 2, 8, 16
WC = TC + 8
BF = jnp.bfloat16


def _draw(shape, seed):
    return (np.random.default_rng(seed).integers(0, 16, shape) / 16).astype(
        np.float32)


def _both(a: np.ndarray):
    """The same bf16 values for JAX and for the port."""
    return jnp.asarray(a).astype(BF), torch.from_numpy(a).to(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jbits(a) -> np.ndarray:
    return np.array(jax.lax.bitcast_convert_type(a, jnp.uint16))


# --- tools/tmm_probe.py:79 (cch, body_ch :293-304) ---------------------------
def _body_ch(x, w, out, acc):
    a = acc.at[0:TR, 0:WC, :]
    for t in range(4):
        p = jax.lax.dot_general(
            x[0][t:t + TR, t:t + WC, :], w[t],
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        if t == 0:
            a[...] = p
        else:
            a[...] += p
    out[0] = acc[0:TR, 0:TC, :].astype(BF)


def cch(x, w):
    return pl.pallas_call(
        _body_ch, grid=(B, NY, NX),
        in_specs=[pl.BlockSpec((1, TR + 8, TC + 16, 128),
                               lambda n, i, j: (n, i, j, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((4, 128, 128), lambda n, i, j: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, TR, TC, 128), lambda n, i, j: (n, i, j, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, NY * TR, NX * TC, 128), BF),
        scratch_shapes=[pltpu.VMEM((TR, TC + 16, 128), jnp.float32)],
        interpret=True)(x, w)


# --- tools/tmm_probe.py:122 (cpos, body_pos :333-347) ------------------------
def _body_pos(x, w, out, acc):
    def row(r, _):
        a = None
        for t in range(4):
            p = jax.lax.dot_general(
                w[t], jax.lax.dynamic_slice(
                    x[0], (r + t, 0, t), (1, 128, WC))[0],
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            a = p if a is None else a + p
        acc[r] = a.astype(BF)
        return 0

    jax.lax.fori_loop(0, TR, row, 0)
    out[0] = acc[:, :, 0:TC]


def cpos(x, w):
    return pl.pallas_call(
        _body_pos, grid=(B, NY, NX),
        in_specs=[pl.BlockSpec((1, TR + 8, 128, TC + 16),
                               lambda n, i, j: (n, i, 0, j),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((4, 128, 128), lambda n, i, j: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, TR, 128, TC), lambda n, i, j: (n, i, 0, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, NY * TR, 128, NX * TC), BF),
        scratch_shapes=[pltpu.VMEM((TR, 128, TC + 8), BF)],
        interpret=True)(x, w)


@pytest.fixture(scope="module")
def inputs():
    """(x chlane, x poslane (the same values permuted), w), each as (jax,
    torch)."""
    x = _draw(probe.tmm_input_shape("chlane", B, NY, NX, TR, TC), 0)
    w = _draw((4, 128, 128), 1)
    return _both(x), _both(np.ascontiguousarray(x.transpose(0, 1, 3, 2))), \
        _both(w)


@pytest.mark.parametrize("layout,body", [("chlane", cch), ("poslane", cpos)],
                         ids=["tmm_probe_79_cch", "tmm_probe_122_cpos"])
def test_plain_matches_the_jax_body(inputs, layout, body):
    xc, xp, (jw, tw) = inputs
    jx, tx = xc if layout == "chlane" else xp
    ref = body(jx, jw)
    got = probe.tap_mm(tx, tw, layout, (TR, TC))
    assert tuple(got.shape) == ref.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jbits(ref))


def test_layouts_agree_on_permuted_inputs(inputs):
    (_, xc), (_, xp), (_, w) = inputs
    ch = probe.tap_mm(xc, w, "chlane", (TR, TC))
    pos = probe.tap_mm(xp, w, "poslane", (TR, TC))
    assert torch.equal(pos.permute(0, 1, 3, 2), ch)


def test_exact_sums_make_one_dropped_term_visible(inputs):
    """On k / 16 inputs the bit-equal bar sees a kernel that dropped one tap
    or one input channel of one position."""
    (_, x), _, (_, w) = inputs
    ref = probe.tap_mm_plain(x, w, "chlane", (TR, TC))
    bad_w = w.clone()
    bad_w[3] = 0.0
    assert not torch.equal(probe.tap_mm_plain(x, bad_w, "chlane", (TR, TC)),
                           ref)
    bad_x = x.clone()
    bad_x[0, 3, 3, 5] += 1.0      # read by outputs (3 - t, 3 - t) at tap t
    diff = (probe.tap_mm_plain(bad_x, w, "chlane", (TR, TC)) != ref).any(-1)
    assert {tuple(p) for p in diff.nonzero().tolist()} == {
        (0, 3 - t, 3 - t) for t in range(4)}


def test_grid_is_the_disjoint_blocks_the_input_holds():
    """(ny, nx) are as many (tr+8, tc+16) blocks as fit; the JAX tool's
    arrays hold exactly its grid."""
    for layout in probe.TMM_LAYOUTS:
        shape = probe.tmm_input_shape(layout, 16, 8, 4, 64, 128)
        assert shape == ((16, 576, 640, 128) if layout == "chlane"
                         else (16, 576, 128, 640))
        x = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
        w = torch.zeros((4, 128, 128), dtype=torch.bfloat16, device="meta")
        assert probe._tmm_check(x, w, layout, (64, 128)) == (8, 4)


def test_bound_from_the_code():
    """1.150 GB of input that the taps read (67 x 131 positions a cell),
    1.074 GB of output: 0.664 ms at 3.35 TB/s, over the operations' 0.556 ms
    at 989 TFLOP/s."""
    b = probe.tap_mm_bound(16, 8, 4, 64, 128)
    assert b["bytes"] == 2 * (16 * 32 * (67 * 131 + 64 * 128) * 128
                              + 4 * 128 * 128)
    assert round(b["bytes_ms"], 3) == 0.664 and round(b["ops_ms"], 3) == 0.556
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert b["flops"] == 2 * 4 * 128 * 128 * 16 * 512 * 512


def test_pack_tap_mm_is_the_kernel_operand_order():
    """pack_tap_mm is the register order csrc/tmm.cu loads: warpgroup h,
    k16 step s, thread 32v + 4g + c, register r, half e holds
    W^T[64h + 16v + g + 8(r % 2), 16s + 8(r // 2) + 2c + e] (mma.cuh's A
    fragment), k = 128 t + ci; every weight exactly once."""
    w = torch.arange(4 * 128 * 128, dtype=torch.float32).reshape(4, 128, 128)
    wp = probe.pack_tap_mm(w)
    assert tuple(wp.shape) == (2, 32, 128, 8)
    for h, s, v, g, c, r, e in ((0, 0, 0, 0, 0, 0, 0), (1, 19, 2, 5, 1, 3, 1),
                                (0, 31, 3, 7, 3, 2, 0), (1, 8, 1, 0, 2, 1, 1)):
        k = 16 * s + 8 * (r // 2) + 2 * c + e
        co = 64 * h + 16 * v + g + 8 * (r % 2)
        assert wp[h, s, 32 * v + 4 * g + c, 2 * r + e] == w[k // 128,
                                                              k % 128, co]
    assert torch.equal(wp.flatten().sort().values, w.flatten())


@pytest.mark.parametrize("b,ny,nx,tr,tc,blocks", [
    (16, 8, 4, 64, 128, 132),   # the JAX tool's grid on an H100
    (2, 2, 1, 5, 256, 3),       # two segments a cell row, odd tr
    (1, 3, 1, 37, 128, 132),    # fewer rows than blocks: one row each
    (3, 1, 2, 13, 384, 7)])
def test_walk_covers_every_row_once(b, ny, nx, tr, tc, blocks):
    """tmm_walk (the kernel's walk): every row of work lies in exactly one
    unit of one block, the blocks' shares differ by one row at most, a unit
    stays inside one segment, and some unit is partial (shorter than tr);
    chlane's units load ob - oa + 3 rows, 3 halo rows a unit."""
    nseg = tc // 128
    units = probe.tmm_walk(b, ny, nx, tr, tc, blocks)
    total = b * ny * nx * nseg * tr
    assert len(units) == min(total, blocks)
    seen = [(s, o) for mine in units for s, oa, ob in mine
            for o in range(oa, ob)]
    assert sorted(seen) == [(s, o) for s in range(b * ny * nx * nseg)
                            for o in range(tr)]
    shares = [sum(ob - oa for _, oa, ob in mine) for mine in units]
    assert max(shares) - min(shares) <= 1
    assert all(0 <= oa < ob <= tr for mine in units for _, oa, ob in mine)
    assert any(ob - oa < tr for mine in units for _, oa, ob in mine)


def _emulate_tap_mm(x, w, layout, tr, tc, blocks):
    """The kernel's arithmetic, block by block as csrc/tmm.cu orders it:
    each unit's loads (its cell rows oa .. ob + 2, positions col0 ..) into
    a ring of 5 slots, each written only once the rows that read the load 5
    before it are done (else the kernel would stall for good); poslane's
    row staged as 17 groups [128 ch][8 positions] and transposed into the
    slot's [position][channel] layout; output row o's taps t reading load
    L + o - oa + t from position t; W^T from pack_tap_mm's fragments by the
    register map, f32 sums."""
    b = x.shape[0]
    rows, cols = (x.shape[1], x.shape[2]) if layout == "chlane" else (
        x.shape[1], x.shape[3])
    ny, nx = rows // (tr + 8), cols // (tc + 16)
    nseg, stages = tc // 128, 5
    xf = x.float()
    wp = probe.pack_tap_mm(w).float()
    wt = torch.zeros(2, 64, 512)    # W^T of each warpgroup from the registers
    for s in range(32):
        for th in range(128):
            v, g, c = th // 32, (th % 32) // 4, th % 4
            for r in range(4):
                for e in range(2):
                    wt[:, 16 * v + g + 8 * (r % 2),
                       16 * s + 8 * (r // 2) + 2 * c + e] = wp[:, s, th,
                                                               2 * r + e]
    wt = wt.reshape(128, 4, 128)    # [co, t, ci]

    def slot_of(n, row, col0):
        """A load as its slot holds it: [136 positions, 128 channels]."""
        if layout == "chlane":
            return xf[n, row, col0:col0 + 136]
        staged = torch.stack([xf[n, row, :, col0 + 8 * g:col0 + 8 * g + 8]
                              for g in range(17)])        # [g][ch][pos]
        return staged.permute(0, 2, 1).reshape(136, 128)  # [8g + p][ch]

    out = torch.zeros(b, ny * tr, nx * tc, 128)
    for mine in probe.tmm_walk(b, ny, nx, tr, tc, blocks):
        loads, done, L, pending = [], set(), 0, []
        for s, oa, ob in mine:
            n, rest = divmod(s, ny * nx * nseg)
            i, rest = divmod(rest, nx * nseg)
            j, seg = divmod(rest, nseg)
            pending += [(n, i * (tr + 8) + r, j * (tc + 16) + 128 * seg)
                        for r in range(oa, ob + 3)]
        n_loads, rows_lr, k0 = len(pending), set(), 0
        for s, oa, ob in mine:      # each row's first load
            rows_lr.update(range(k0, k0 + ob - oa))
            k0 += ob - oa + 3
        for s, oa, ob in mine:
            n, rest = divmod(s, ny * nx * nseg)
            i, rest = divmod(rest, nx * nseg)
            j, seg = divmod(rest, nseg)
            for o in range(oa, ob):
                lr = L + o - oa
                while len(loads) <= lr + 3:
                    k = len(loads)
                    # slot k % 5 held load k - 5: every row reading it done
                    assert all(q in done for q in range(k - stages - 3,
                                                        k - stages + 1)
                               if q in rows_lr)
                    loads.append(slot_of(*pending.pop(0)))
                acc = torch.zeros(128, 128)
                for t in range(4):
                    acc += wt[:, t] @ loads[lr + t][t:t + 128].t()
                done.add(lr)
                out[n, i * tr + o, j * tc + 128 * seg:
                    j * tc + 128 * seg + 128] = acc.t()
            L += ob - oa + 3
        assert not pending and len(loads) == n_loads == L
    out = out.to(torch.bfloat16)
    return out if layout == "chlane" else out.permute(0, 1, 3, 2)


@pytest.mark.parametrize("layout", list(probe.TMM_LAYOUTS))
@pytest.mark.parametrize("tr,tc,blocks", [(5, 256, 3), (7, 128, 4)],
                         ids=["two_segments", "odd_rows"])
def test_kernel_walk_and_packing_give_the_layer(layout, tr, tc, blocks):
    """An emulation of csrc/tmm.cu's walk, ring, poslane's staging and
    transposition and the register operands on k / 16 inputs equals
    tap_mm_plain bit for bit, with partial units, and no load overwrites a
    slot before the rows that read it are done."""
    x, w = probe.tmm_inputs(probe.tmm_input_shape(layout, 2, 2, 1, tr, tc),
                            3, "cpu")
    got = _emulate_tap_mm(x, w, layout, tr, tc, blocks)
    ref = probe.tap_mm_plain(x, w, layout, (tr, tc))
    assert torch.equal(got, ref)


def test_wrapper_refuses_bad_arguments(inputs):
    (_, x), (_, xp), (_, w) = inputs
    with pytest.raises(ValueError, match="layout"):
        probe.tap_mm(x, w, "lanes", (TR, TC))
    with pytest.raises(ValueError, match="channels"):
        probe.tap_mm(x, w, "poslane", (TR, TC))
    with pytest.raises(ValueError, match="channels"):
        probe.tap_mm(x[..., :64].contiguous(), w, "chlane", (TR, TC))
    with pytest.raises(TypeError, match="bfloat16"):
        probe.tap_mm(x.float(), w, "chlane", (TR, TC))
    with pytest.raises(TypeError, match="contiguous"):
        probe.tap_mm(xp.permute(0, 1, 3, 2), w, "chlane", (TR, TC))
    with pytest.raises(ValueError, match="w must be"):
        probe.tap_mm(x, w[:3], "chlane", (TR, TC))
    with pytest.raises(ValueError, match="holds no"):
        probe.tap_mm(x[:, :10].contiguous(), w, "chlane", (TR, TC))
    with pytest.raises(ValueError, match="tile"):
        probe.tap_mm(x, w, "chlane", (0, TC))
    with pytest.raises(ValueError, match="no kernel"):
        probe.prepare_tap_mm(x, w, "chlane", (TR, TC))


def test_plain_versions_launch_nothing(inputs):
    (_, x), (_, xp), (_, w) = inputs
    probe.reset_launches()
    probe.tap_mm(x, w, "chlane", (TR, TC))
    probe.tap_mm(xp, w, "poslane", (TR, TC))
    probe.tap_mm_plain(x, w, "chlane", (TR, TC))
    assert probe.LAUNCHES["tap_mm"] == 0 and not any(probe.LAUNCHES.values())


def test_library_yardsticks_compute_the_layer(inputs):
    """The matmul yardstick's blocks and the conv's cell positions hold the
    layer's values (both round in bf16 at other places: within 2^-7 of the
    largest output)."""
    (_, x), (_, xp), (_, w) = inputs
    ref = probe.tap_mm_plain(x, w, "chlane", (TR, TC)).float()
    tol = ref.abs().max().item() * 2.0 ** -7
    for layout, xl in (("chlane", x), ("poslane", xp)):
        lib = probe.tap_mm_library(xl, w, layout, (TR, TC))
        mm = lib["matmul"]().float()
        if layout == "poslane":
            mm = mm.transpose(-1, -2)
        mm = mm.permute(0, 1, 3, 2, 4, 5).reshape(ref.shape)
        assert (mm - ref).abs().max().item() <= tol
        conv = lib["conv"]().float()
        cells = torch.stack([torch.stack([
            conv[:, :, i * (TR + 8):i * (TR + 8) + TR,
                 j * (TC + 16):j * (TC + 16) + TC]
            for j in range(NX)], dim=-1) for i in range(NY)], dim=-1)
        cells = cells.permute(0, 5, 2, 4, 3, 1).reshape(ref.shape)
        assert (cells - ref).abs().max().item() <= tol


def test_measure_on_cpu_reports_no_device_time():
    r = probe.measure_tap_mm("poslane", 1, 2, 1, 8, 16, torch.device("cpu"),
                             1)
    assert r["ok"] and r["ms"] is None and r["library_ms"] is None
    assert r["bound_ms"] == max(r["bytes_ms"], r["ops_ms"])
    assert "not measured" in probe.format_tap_mm_row(r)


def test_tool_main_on_cpu(capsys):
    rows = []
    assert tmm_probe.main(["--device", "cpu", "--batch", "1", "--size",
                           "32", "--tile", "8", "16", "--iters", "1"],
                          rows) == 0
    assert [r["name"] for r in rows] == list(probe.TMM_LAYOUTS)
    out = capsys.readouterr().out
    assert "no device time" in out and "FAILED" not in out


def test_tool_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmm_probe.main([])


def test_ctypes_signatures_match_the_c_entries():
    """Every argtypes list the wrappers give ctypes has as many entries as
    its C entry point takes: a wrong count only shows when the card calls
    it."""
    import re
    from pathlib import Path

    from waifu2x_torch.ops import stack
    csrc = Path(probe.__file__).resolve().parents[1] / "csrc"
    params = {}
    for src in csrc.glob("*.cu"):
        for name, args in re.findall(r"\bint (w2x_\w+)\(([^)]*)\)",
                                     src.read_text()):
            params[name] = len(args.split(","))
    tables = {**{fn: a for fns in stack._ARGTYPES.values()
                 for fn, a in fns.items()},
              **probe._ARGTYPES, **probe._TMM_ARGTYPES}
    assert {fn: len(a) for fn, a in tables.items()} == {
        fn: params[fn] for fn in tables}
