"""The truncation probes on the CPU against the JAX tools' own kernels:
tools/fused_strip_probe.py:134 (one_body) and :162 (body), tools/
k1_forensics.py:136 and tools/l14_probe.py:145, against the port's
stack_scale_upto in its output forms (out="cell", "whole", "lane0",
"phase_taps"), stack_scale and the probe variants oneblk and xonly.

The JAX scripts run their probes when imported, so each body is restated
here from the cited file:line, at a small grid (tile (8, 16), 2 x 2 cells),
and run in Pallas interpret mode on seeded numpy inputs with the JAX
package's f32 weights (pallas_stack.prep_params(..., jnp.float32)), as
tests/test_torch_l6.py runs the package kernel. Bars: the truncations
within 3e-5 (the JAX kernel suite's f32 bar); the two fetch probes bit for
bit in bf16. k1_forensics writes its activation packed (lanes phase-major,
4 phases x C_k, per s2d cell of a (tr+3, tc+16) window); the test gathers
those lanes onto the port's full-res positions, on the positions that both
define: not the lanes the body leaves unwritten, not the block's columns
past the ones it computes, and not its last k-2 computed columns from layer
3 on, which read a scratch column that no layer wrote. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phase 19)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as ps
from tests.jax_trunc_grid import (
    B, F32, HL, NX, NY, TC, TOL, TR, W_KEYS, W_SPECS, WC, WL, _assemble,
    _block4, _call, _full, _vmem, _xblk, jk1_on_port)
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import probe, stack
from waifu2x_torch.tools import fused_strip_probe, k1_forensics, l14_probe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def kp(params_np):
    return ps.prep_params(params_np, scale_input=True, dtype=F32)


@pytest.fixture(scope="module")
def ylow():
    return np.random.default_rng(7).random((B, HL, WL), np.float32)


# --- tools/fused_strip_probe.py:162 (body :32-122) ---------------------------
def _fs_body(spec, upto, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b, w2c, b2c,
             w5, b5, w6, b6, blk, sel, b7,
             out_ref, xin, x1, x2, x3, x4, x5, zt, acc):
    spec3, spec4, spec5, spec6 = spec
    pair_direct = upto >= 100
    if upto >= 100:
        upto = upto - 100
    _assemble(xin, xa, xb, xc, xd)
    if upto == 0:
        out_ref[0] = jnp.concatenate(
            [xin[0:TR, 0:TC, 0:1]] * 4, axis=-1).astype(F32)
        return
    x1[:] = ps._leaky(ps._dot3(xin[:], l1[:], F32)
                      + b1[0].astype(F32)).astype(F32)
    if upto == 1:
        out_ref[0] = x1[0:TR, 0:TC, 0:4]
        return
    x2[:, 0:WC, :] = _block4(x1, w2a, b2a, TR + 5, acc)
    if upto == 2:
        out_ref[0] = x2[0:TR, 0:TC, 0:4]
        return

    def block_pair(src, w_ref, b_ref, sp, rows, dst):
        vals = []
        for A, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lo, hi, k0, klen) in enumerate(entries):
                part = ps._dot3(src[Dy:Dy + rows, Dx:Dx + WC, lo:hi],
                                w_ref[A, k0:k0 + klen, :], F32)
                if g == 0:
                    a[...] = part
                else:
                    a[...] += part
            val = ps._leaky(a[...] + b_ref[0, A * 128:(A + 1) * 128]
                            .astype(F32)).astype(F32)
            if pair_direct:
                dst[:, 0:WC, A * 128:(A + 1) * 128] = val
            else:
                vals.append(val)
        if not pair_direct:
            dst[:, 0:WC, :] = jnp.concatenate(vals, axis=-1)

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3)
    if upto == 3:
        out_ref[0] = x3[0:TR, 0:TC, 0:4]
        return
    block_pair(x3, w2c, b2c, spec4, TR + 3, x4)
    if upto == 4:
        out_ref[0] = x4[0:TR, 0:TC, 0:4]
        return
    ps._mid_sparse(x4, w5, b5, spec5, TR + 2, WC, 128, F32, x5, acc)
    if upto == 5:
        out_ref[0] = x5[0:TR, 0:TC, 0:4]
        return
    rows = TR + 1
    for p, entries in enumerate(spec6):
        a = acc.at[0:rows, 0:WC, 0:128]
        for g, (Dy, Dx, lanes, k0, klen) in enumerate(entries):
            part = ps._dot3(ps._gather_k(x5, rows, WC, Dy, Dx, lanes),
                            w6[p, k0:k0 + klen, :], F32)
            if g == 0:
                a[...] = part
            else:
                a[...] += part
        x6p = ps._leaky(a[...] + b6[0, p * 128:(p + 1) * 128].astype(F32)
                        ).astype(F32)
        zt[:, 0:WC, p * 16:(p + 1) * 16] = ps._dot3(
            x6p, blk[p * 128:(p + 1) * 128, p * 16:(p + 1) * 16]
        ).astype(zt.dtype)
    if upto == 6:
        out_ref[0] = zt[0:TR, 0:TC, 0:4].astype(F32)
        return
    y = None
    for Dy in (0, 1):
        for Dx in (0, 1):
            part = ps._dot3(zt[Dy:Dy + TR, Dx:Dx + TC, :],
                            sel[(Dy * 2 + Dx) * 64:(Dy * 2 + Dx + 1) * 64, :])
            y = part if y is None else y + part
    out_ref[0] = ps._leaky(y + b7[0, 0]).astype(F32)


def jfused_strip(kp, ylow, upto):
    arrays, spec = kp
    xcol = ps._xcol_scale(jnp.asarray(ylow), TR, TC)
    in_specs = ([_xblk(0, 0), _xblk(0, 1), _xblk(1, 0), _xblk(1, 1)] + W_SPECS
                + [_full((4, 576, 128)), _full((1, 512)),
                   _full((4, 1152, 128)), _full((1, 512)), _full((512, 64)),
                   _full((256, 4)),
                   pl.BlockSpec((1, 1), lambda n, i, j: (0, 0),
                                memory_space=pltpu.SMEM)])
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 16), F32),
               pltpu.VMEM((TR + 6, TC + 16, 128), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 256), F32),
               pltpu.VMEM((TR + 3, TC + 16, 256), F32),
               pltpu.VMEM((TR + 2, TC + 16, 512), F32),
               pltpu.VMEM((TR + 1, TC + 16, 64), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32)]
    keys = W_KEYS + ("w5", "b5", "w6", "b6", "l7_blk", "l7_sel", "b7")
    return _call(functools.partial(_fs_body, spec, upto), in_specs,
                 _vmem((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
                 jax.ShapeDtypeStruct((B, HL, WL, 4), F32), scratch,
                 xcol, xcol, xcol, xcol, *(arrays[k] for k in keys))


@pytest.mark.parametrize("mode", ["0", "1", "2", "3", "4", "5", "6", "7",
                                  "107"])
def test_fused_strip_probe_162(kp, sp32, ylow, mode):
    """Each mode against the port's counterpart (tools/fused_strip_probe's
    RUNS), within 3e-5: 0 lane0, 1-5 the cell form, 6 phase_taps, 7 and 107
    (PAIR_DIRECT, a Mosaic store schedule) the whole stack."""
    ref = jfused_strip(kp, ylow, int(mode))
    _, upto, out = fused_strip_probe.RUNS[mode]
    y = torch.from_numpy(ylow)
    got = (stack.stack_scale(y, sp32) if upto == 7
           else stack.stack_scale_upto(y, sp32, upto, out=out))
    assert got.shape == (B, HL, WL, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_fused_strip_dimsem_is_the_whole_stack(kp, sp32, ylow):
    """dimsem changes the Pallas call's dimension_semantics only: the JAX
    body at upto 7 under it equals the port's stack_scale within 3e-5."""
    ref = jfused_strip(kp, ylow, 7)
    assert fused_strip_probe.RUNS["dimsem"][1] == 7
    got = stack.stack_scale(torch.from_numpy(ylow), sp32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


# --- tools/k1_forensics.py:136 (body :25-124) --------------------------------
def _k1_body(spec, upto, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b, w2c, b2c,
             out_ref, xin, x1, x2, x3, acc, x3a, x3b):
    spec3, spec4 = spec[0], spec[1]
    _assemble(xin, xa, xb, xc, xd)
    if upto == 0:
        out_ref[0, :, 0:WC, 0:16] = xin[0:TR + 3, 0:WC, :]
        return
    x1[:] = ps._leaky(ps._dot3(xin[:], l1[:], F32)
                      + b1[0].astype(F32)).astype(F32)
    if upto == 1:
        out_ref[0, :, 0:WC, 0:128] = x1[0:TR + 3, 0:WC, :]
        return
    x2[:, 0:WC, :] = _block4(x1, w2a, b2a, TR + 5, acc)
    if upto == 2:
        out_ref[0, :, 0:WC, 0:128] = x2[0:TR + 3, 0:WC, :]
        return

    def block_pair(src, w_ref, b_ref, sp, rows, dst, is_out):
        vals = []
        for A, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lo, hi, k0, klen) in enumerate(entries):
                part = ps._dot3(src[Dy:Dy + rows, Dx:Dx + WC, lo:hi],
                                w_ref[A, k0:k0 + klen, :], F32)
                if g == 0:
                    a[...] = part
                else:
                    a[...] += part
            vals.append(ps._leaky(a[...] + b_ref[0, A * 128:(A + 1) * 128]
                                  .astype(F32)).astype(F32))
        val = jnp.concatenate(vals, axis=-1)
        if is_out:
            dst[0, :, 0:WC, :] = val
        else:
            dst[:, 0:WC, :] = val

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3, False)
    if upto == 3:
        out_ref[0, :, 0:WC, 0:256] = x3[0:TR + 3, 0:WC, :]
        return
    if upto == 4:
        block_pair(x3, w2c, b2c, spec4, TR + 3, out_ref, True)
        return
    rows = TR + 3
    vals = []
    if upto == 6:
        x3a[:, 0:WC, :] = x3[0:TR + 4, 0:WC, 0:128]
        x3b[:, 0:WC, :] = x3[0:TR + 4, 0:WC, 128:256]
    for A, entries in enumerate(spec4):
        a = acc.at[0:rows, 0:WC, 0:128]
        first = True
        for (Dy, Dx, lo, hi, k0, klen) in entries:
            if upto == 6:
                if klen == 256:
                    ops = [jnp.concatenate(
                        [x3a[Dy:Dy + rows, Dx:Dx + WC, :],
                         x3b[Dy:Dy + rows, Dx:Dx + WC, :]], axis=-1)]
                elif lo == 0:
                    ops = [x3a[Dy:Dy + rows, Dx:Dx + WC, :]]
                else:
                    ops = [x3b[Dy:Dy + rows, Dx:Dx + WC, :]]
                parts = [(ops[0], w2c[A, k0:k0 + klen, :])]
            else:   # upto 5: every K > 128 dot split into K = 128 dots
                parts = []
                for ofs in range(0, klen, 128):
                    kk = min(128, klen - ofs)
                    parts.append((x3[Dy:Dy + rows, Dx:Dx + WC,
                                     lo + ofs:lo + ofs + kk],
                                  w2c[A, k0 + ofs:k0 + ofs + kk, :]))
            for op, wk in parts:
                part = ps._dot3(op, wk, F32)
                if first:
                    a[...] = part
                    first = False
                else:
                    a[...] += part
        vals.append(ps._leaky(a[...] + b2c[0, A * 128:(A + 1) * 128]
                              .astype(F32)).astype(F32))
    out_ref[0, :, 0:WC, :] = jnp.concatenate(vals, axis=-1)


def jk1(kp, ylow, upto):
    arrays, spec = kp
    xcol = ps._xcol_scale(jnp.asarray(ylow), TR, TC)
    hb, wb = TR + 3, TC + 16
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 16), F32),
               pltpu.VMEM((TR + 6, TC + 16, 128), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 256), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 128), F32)]
    return _call(functools.partial(_k1_body, spec, upto),
                 [_xblk(0, 0), _xblk(0, 1), _xblk(1, 0), _xblk(1, 1)]
                 + W_SPECS,
                 _vmem((1, hb, wb, 256), lambda n, i, j: (n, i, j, 0)),
                 jax.ShapeDtypeStruct((B, NY * hb, NX * wb, 256), F32),
                 scratch, xcol, xcol, xcol, xcol,
                 *(arrays[k] for k in W_KEYS))


@pytest.mark.parametrize("mode", range(7))
def test_k1_forensics_136(kp, sp32, ylow, mode):
    """Mode k (0-4) against the port's out="whole" at upto k, mode 5 and 6
    (layer 4 with its K or its lanes split, Mosaic schedules) against
    upto 4, within 3e-5, on every position that both define; at least
    three quarters of the port's plane (all of its inner part) is covered."""
    jout = jk1(kp, ylow, mode)
    upto = min(mode, 4)
    whole = stack.stack_scale_upto(torch.from_numpy(ylow), sp32, upto,
                                   out="whole")
    side = ((HL + 8, WL + 8, 1) if upto == 0 else
            (2 * HL + 14 - 2 * upto, 2 * WL + 14 - 2 * upto,
             stack.WIDTHS[upto - 1][1]))
    assert tuple(whole.shape) == (B, *side)
    ref, got = jk1_on_port(jout, whole.numpy(), upto)
    assert got.size >= 0.75 * whole.numel()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


# --- tools/l14_probe.py:145 (body :54-115) --------------------------------
CB, RB = TC // 16, TR // 8
L14_IN = [_xblk(0, 0),
          _vmem((1, TR, 16, 16), lambda n, i, j: (n, i, (j + 1) * CB, 0)),
          _vmem((1, 8, TC, 16), lambda n, i, j: (n, (i + 1) * RB, j, 0)),
          _vmem((1, 8, 16, 16),
                lambda n, i, j: (n, (i + 1) * RB, (j + 1) * CB, 0))]


def _l14_body(spec, upto, cdt, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b,
              w2c, b2c, out_ref, bufa, bufb, acc):
    spec3, spec4 = spec[0], spec[1]
    x1 = bufa.at[:, :, 0:128]
    x2 = bufb.at[0:TR + 5, :, 0:128]
    x3 = bufa.at[0:TR + 4, :, 0:256]
    x4 = bufb.at[0:TR + 3, :, 0:256]
    if upto == 0:
        t = (xa[0][0:TR, 0:TC, 0:4].astype(F32)
             + xb[0][0:TR, 0:4, 0:4].astype(F32)[:, 0:1]
             + xc[0][0:6, 0:TC, 0:4].astype(F32)[0:1]
             + xd[0][0:6, 0:4, 0:4].astype(F32)[0:1, 0:1])
        out_ref[0] = t.astype(cdt)
        return
    b1v = b1[0].astype(F32)

    def l1q(q):
        return ps._leaky(ps._dot3(q, l1[:], F32) + b1v).astype(cdt)

    x1[0:TR, 0:TC, :] = l1q(xa[0])
    x1[0:TR, TC:TC + 16, :] = l1q(xb[0][:, 0:16, :])
    x1[TR:TR + 6, 0:TC, :] = l1q(xc[0][0:6, :, :])
    x1[TR:TR + 6, TC:TC + 16, :] = l1q(xd[0][0:6, 0:16, :])
    if upto == 1:
        out_ref[0] = x1[0:TR, 0:TC, 0:4]
        return
    x2[:, 0:WC, :] = _block4(x1, w2a, b2a, TR + 5, acc)
    if upto == 2:
        out_ref[0] = x2[0:TR, 0:TC, 0:4]
        return

    def block_pair(src, w_ref, b_ref, sp, rows, dst):
        vals = []
        for A, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lo, hi, k0, klen) in enumerate(entries):
                part = ps._dot3(src[Dy:Dy + rows, Dx:Dx + WC, lo:hi],
                                w_ref[A, k0:k0 + klen, :], F32)
                if g == 0:
                    a[...] = part
                else:
                    a[...] += part
            vals.append(ps._leaky(a[...] + b_ref[0, A * 128:(A + 1) * 128]
                                  .astype(F32)).astype(cdt))
        dst[:, 0:WC, :] = jnp.concatenate(vals, axis=-1)

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3)
    if upto == 3:
        out_ref[0] = x3[0:TR, 0:TC, 0:4]
        return
    block_pair(x3, w2c, b2c, spec4, TR + 3, x4)
    out_ref[0] = x4[0:TR, 0:TC, 0:4]


def jl14(kp, x16, upto):
    """The l14 body on the 16-lane array x16 (its dtype is the body's)."""
    arrays, spec = kp
    cdt = x16.dtype
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 512), cdt),
               pltpu.VMEM((TR + 5, TC + 16, 256), cdt),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32)]
    ws = [arrays[k] if k.startswith("b") else arrays[k].astype(cdt)
          for k in W_KEYS]
    return _call(functools.partial(_l14_body, spec, upto, cdt),
                 L14_IN + W_SPECS,
                 _vmem((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
                 jax.ShapeDtypeStruct((B, HL, WL, 4), cdt), scratch,
                 x16, x16, x16, x16, *ws)


@pytest.mark.parametrize("upto", [1, 2, 3, 4])
def test_l14_probe_145_upto(kp, sp32, ylow, upto):
    """upto1..4 (layer 1 applied to the four window quadrants directly)
    against the port's cell form, within 3e-5."""
    ref = jl14(kp, ps._xcol_scale(jnp.asarray(ylow), TR, TC), upto)
    got = stack.stack_scale_upto(torch.from_numpy(ylow), sp32, upto)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


G = probe.Grid(B, NY, NX, TR, TC)


def _x16_bf16(seed: int):
    """A seeded bf16 x16 array of the probe grid for both sides."""
    x = np.random.default_rng(seed).random(probe.array_shape("x16", G),
                                           np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(F32))).to(torch.bfloat16)
    return jx, tx


def _bits_equal(got: torch.Tensor, ref) -> None:
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.array(jax.lax.bitcast_convert_type(ref, jnp.uint16)))


def test_l14_probe_145_xonly(kp):
    """xonly: the tile and its three stripes summed in f32 to 4 lanes, bf16
    out, against the probe variant, bit for bit."""
    jx, tx = _x16_bf16(1)
    arrays, spec = kp
    ref = pl.pallas_call(
        functools.partial(_l14_body, spec, 0, jnp.bfloat16),
        grid=(B, NY, NX), in_specs=L14_IN + W_SPECS,
        out_specs=_vmem((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((B, HL, WL, 4), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((TR + 6, TC + 16, 512), jnp.bfloat16),
                        pltpu.VMEM((TR + 5, TC + 16, 256), jnp.bfloat16),
                        pltpu.VMEM((TR + 5, TC + 16, 128), F32)],
        interpret=True)(jx, jx, jx, jx, *(arrays[k] for k in W_KEYS))
    _bits_equal(probe.run(probe.VARIANTS["xonly"], G, {"x": tx}), ref)


# --- tools/fused_strip_probe.py:134 (one_body :125-130) ----------------------
def _one_body(xa, out_ref, xin):
    xin[0:TR, 0:TC, :] = xa[0]
    out_ref[0] = jnp.concatenate(
        [xin[0:TR, 0:TC, 0:1]] * 4, axis=-1).astype(jnp.bfloat16)


def test_fused_strip_probe_134_oneblk():
    """oneblk: one (tr, tc, 16) block fetched, lane 0 written to 4 lanes,
    against the probe variant, bit for bit in bf16."""
    jx, tx = _x16_bf16(2)
    ref = pl.pallas_call(
        _one_body, grid=(B, NY, NX), in_specs=[_xblk(0, 0)],
        out_specs=_vmem((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((B, HL, WL, 4), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((TR + 6, TC + 16, 16), jnp.bfloat16)],
        interpret=True)(jx)
    _bits_equal(probe.run(probe.VARIANTS["oneblk"], G, {"x": tx}), ref)


# --- the forms, the wrappers, the tools -------------------------------------
def test_forms_are_checked(sp32, ylow):
    y = torch.from_numpy(ylow)
    for upto, out in ((3, "lane0"), (6, "whole"), (5, "phase_taps"),
                      (2, "bogus")):
        with pytest.raises(ValueError, match="out="):
            stack.stack_scale_upto(y, sp32, upto, out=out)
        with pytest.raises(ValueError, match="out="):
            stack.stack_scale_upto_plain(y, sp32, upto, out=out)


def test_whole_agrees_with_the_cell_form(sp32, ylow):
    """The cell form is the whole plane's pixels (2i, 2j), channels 0-3;
    lane0 is the cell form's tap (0, 0) in every lane; the whole input
    window holds ylow at rows and columns 4.."""
    y = torch.from_numpy(ylow)
    for k in range(1, 6):
        whole = stack.stack_scale_upto(y, sp32, k, out="whole")
        assert torch.equal(whole[:, 0:2 * HL:2, 0:2 * WL:2, 0:4],
                           stack.stack_scale_upto(y, sp32, k))
    cell0 = stack.stack_scale_upto(y, sp32, 0)
    lane0 = stack.stack_scale_upto(y, sp32, 0, out="lane0")
    assert torch.equal(lane0, cell0[..., 0:1].expand_as(lane0))
    pad = stack.stack_scale_upto(y, sp32, 0, out="whole")[..., 0]
    assert torch.equal(pad[:, 4:4 + HL, 4:4 + WL], y)


@pytest.mark.parametrize("tool,argv,n_rows", [
    (fused_strip_probe, fused_strip_probe.MODES, 11),
    (k1_forensics, k1_forensics.MODES, 7),
    (l14_probe, [], 5)])
def test_tool_main_on_cpu(tool, argv, n_rows, capsys):
    rows = []
    assert tool.main(list(argv) + ["--device", "cpu", "--batch", "1",
                                   "--size", "32", "--tile", "16", "32",
                                   "--iters", "1"], rows) == 0
    assert len(rows) == n_rows
    out = capsys.readouterr().out
    assert "no device time" in out and "FAILED" not in out
    assert all(r["bound_ms"] > 0 for r in rows)


def test_tool_defaults_are_the_jax_tools():
    assert fused_strip_probe.DEFAULT == ["0", "1", "2", "3", "4", "5", "6",
                                         "7", "dimsem"]
    assert k1_forensics.DEFAULT == ["4", "6"]
    assert l14_probe.MODES == ["xonly", "upto1", "upto2", "upto3", "upto4"]


def test_cpu_forms_launch_nothing(sp32, ylow):
    stack.reset_launches()
    y = torch.from_numpy(ylow)
    for out, ks in stack.UPTO_OUTS.items():
        for k in ks:
            stack.stack_scale_upto(y, sp32, k, out=out)
    assert stack.LAUNCHES == 0 and not any(stack.L6_LAUNCHES.values())
    assert not any(stack.KERNEL_LAUNCHES.values())
