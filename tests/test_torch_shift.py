"""The last three probe sites on the CPU against the JAX tools' own kernels:
tools/shift_cost_probe.py:156 (the stack with its cell offsets Dx and/or Dy
of layers 2-7 forced to 0), tools/accpp_probe.py:127 (the stack with two
alternating accumulators) and tools/l4_shift_probe.py:130 (layers 1-3, then
layer 4 by mode), against the port's ops/probe.py: shift_stack,
stack_scale_pp and l4_shift, whose plain versions run here.

The JAX scripts run their probes when imported, so each body is restated
from the cited file:line at the small grid of tests/jax_trunc_grid.py (tile
(8, 16), 2 x 2 cells) and run in Pallas interpret mode on seeded numpy
inputs with the JAX package's f32 weights, as tests/test_torch_trunc.py
does. Bar: 3e-5, the JAX kernel suite's f32 bar. The zero-shift function
is checked apart against numpy loops over r(p, k) = (p & ~1) | ((p + k) & 1),
the position tap k of output position p reads on a zeroed axis. The CUDA
kernels (csrc/mma.cu's ZS and PP variants, csrc/stack.cu's layer 7 under
ZS) are held against these plain versions on the card by chip_smoke.py
(phase 20)."""

import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.jax_trunc_grid import (
    B, F32, HL, NX, NY, TC, TOL, TR, W_KEYS, W_SPECS, WC, WL, _assemble,
    _block4, _call, _full, _vmem, _xblk, jk1_on_port, k1_defined)
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.ops import pallas_stack as ps
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops import probe, stack
from waifu2x_torch.tools import accpp_probe, l4_shift_probe, shift_cost_probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MID = list(range(2, 7))


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def sp16(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")


@pytest.fixture(scope="module")
def kp(params_np):
    return ps.prep_params(params_np, scale_input=True, dtype=F32)


@pytest.fixture(scope="module")
def ylow():
    return np.random.default_rng(8).random((B, HL, WL), np.float32)


def _xcol(ylow):
    return ps._xcol_scale(jnp.asarray(ylow), TR, TC)


L7_IN = [_full((4, 576, 128)), _full((1, 512)), _full((4, 1152, 128)),
         _full((1, 512))]
B7_SMEM = pl.BlockSpec((1, 1), lambda n, i, j: (0, 0),
                       memory_space=pltpu.SMEM)
OUT4 = _vmem((1, TR, TC, 4), lambda n, i, j: (n, i, j, 0))


# --- tools/shift_cost_probe.py:156 (body :48-142) ----------------------------
def _shift_body(fx, fy, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b, w2c, b2c,
                w5, b5, w6, b6, blk2, b7, out_ref, bufa, bufb, zt, acc,
                spec):
    spec3, spec4, spec5, spec6 = spec
    x1 = bufa.at[:, :, 0:128]
    x2 = bufb.at[0:TR + 5, :, 0:128]
    x3 = bufa.at[0:TR + 4, :, 0:256]
    x4 = bufb.at[0:TR + 3, :, 0:256]
    x5 = bufa.at[0:TR + 2, :, 0:512]
    b1v = b1[0].astype(F32)

    def l1q(q):
        return ps._leaky(ps._dot3(q, l1[:], F32) + b1v).astype(F32)

    x1[0:TR, 0:TC, :] = l1q(xa[0])
    x1[0:TR, TC:TC + 16, :] = l1q(xb[0][:, 0:16, :])
    x1[TR:TR + 6, 0:TC, :] = l1q(xc[0][0:6, :, :])
    x1[TR:TR + 6, TC:TC + 16, :] = l1q(xd[0][0:6, 0:16, :])

    def block4(src, w_ref, b_ref, rows):
        a = acc.at[0:rows, 0:WC, 0:128]
        a[...] = ps._dot3(src[0:rows, 0:WC, :], w_ref[0], F32)
        a[...] += ps._dot3(src[0:rows, fx:WC + fx, :], w_ref[1], F32)
        a[...] += ps._dot3(src[fy:rows + fy, 0:WC, :], w_ref[2], F32)
        a[...] += ps._dot3(src[fy:rows + fy, fx:WC + fx, :], w_ref[3], F32)
        return ps._leaky(a[...] + b_ref[0].astype(F32)).astype(F32)

    x2[:, 0:WC, :] = block4(x1, w2a, b2a, TR + 5)

    def block_pair(src, w_ref, b_ref, sp, rows, dst):
        vals = []
        for A, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lo, hi, k0, klen) in enumerate(entries):
                dy, dx = Dy * fy, Dx * fx
                part = ps._dot3(src[dy:dy + rows, dx:dx + WC, lo:hi],
                                w_ref[A, k0:k0 + klen, :], F32)
                if g == 0:
                    a[...] = part
                else:
                    a[...] += part
            vals.append(ps._leaky(a[...] + b_ref[0, A * 128:(A + 1) * 128]
                                  .astype(F32)).astype(F32))
        dst[:, 0:WC, :] = jnp.concatenate(vals, axis=-1)

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3)
    block_pair(x3, w2c, b2c, spec4, TR + 3, x4)

    def gather(src, rows, Dy, Dx, lane_slices):
        dy, dx = Dy * fy, Dx * fx
        parts = [src[dy:dy + rows, dx:dx + WC, lo:hi]
                 for lo, hi in lane_slices]
        return parts[0] if len(parts) == 1 else jnp.concatenate(
            parts, axis=-1)

    def mid(src, w_ref, b_ref, sp, rows, dst):
        for p, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lanes, k0, klen) in enumerate(entries):
                part = ps._dot3(gather(src, rows, Dy, Dx, lanes),
                                w_ref[p, k0:k0 + klen, :], F32)
                if g == 0:
                    a[...] = part
                else:
                    a[...] += part
            dst[:, 0:WC, p * 128:(p + 1) * 128] = ps._leaky(
                a[...] + b_ref[0, p * 128:(p + 1) * 128].astype(F32)
            ).astype(F32)

    mid(x4, w5, b5, spec5, TR + 2, x5)
    rows = TR + 1
    for p, entries in enumerate(spec6):
        a = acc.at[0:rows, 0:WC, 0:128]
        for g, (Dy, Dx, lanes, k0, klen) in enumerate(entries):
            part = ps._dot3(gather(x5, rows, Dy, Dx, lanes),
                            w6[p, k0:k0 + klen, :], F32)
            if g == 0:
                a[...] = part
            else:
                a[...] += part
        x6p = ps._leaky(a[...] + b6[0, p * 128:(p + 1) * 128].astype(F32)
                        ).astype(F32)
        part = ps._dot3(x6p, blk2[p * 128:(p + 1) * 128, :])
        if p == 0:
            zt[:, 0:WC, :] = part.astype(zt.dtype)
        else:
            zt[:, 0:WC, :] += part.astype(zt.dtype)
    y = None
    for Dy in (0, 1):
        for Dx in (0, 1):
            s = Dy * 2 + Dx
            part = zt[Dy * fy:Dy * fy + TR, Dx * fx:Dx * fx + TC,
                      s * 4:s * 4 + 4]
            y = part if y is None else y + part
    out_ref[0] = ps._leaky(y + b7[0, 0]).astype(F32)


def jshift(kp, ylow, fx, fy):
    arrays, spec = kp
    xcol = _xcol(ylow)
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 512), F32),
               pltpu.VMEM((TR + 5, TC + 16, 256), F32),
               pltpu.VMEM((TR + 1, TC + 16, 16), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32)]
    keys = W_KEYS + ("w5", "b5", "w6", "b6", "l7_blk2", "b7")
    return _call(functools.partial(_shift_body, fx, fy, spec=spec),
                 [_xblk(0, 0), _xblk(0, 1), _xblk(1, 0), _xblk(1, 1)]
                 + W_SPECS + L7_IN + [_full((512, 16)), B7_SMEM], OUT4,
                 jax.ShapeDtypeStruct((B, HL, WL, 4), F32), scratch,
                 xcol, xcol, xcol, xcol, *(arrays[k] for k in keys))


@pytest.fixture(scope="module")
def jshift_out(kp, ylow):
    return {mode: jshift(kp, ylow, *f) for mode, f in
            probe.SHIFT_MODES.items()}


@pytest.mark.parametrize("mode", list(probe.SHIFT_MODES))
def test_shift_cost_probe_156(jshift_out, sp32, ylow, mode):
    """Each mode of the JAX body against the port's shift_stack (layers 2-7
    under zero-shift mask shift_zs(fx, fy)), within 3e-5."""
    fx, fy = probe.SHIFT_MODES[mode]
    got = probe.shift_stack(torch.from_numpy(ylow), sp32, fx, fy)
    assert got.shape == (B, HL, WL, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jshift_out[mode], rtol=0,
                               atol=TOL)


def test_shift_cost_base_is_the_stack(jshift_out, sp32, ylow):
    """base (fx = fy = 1) is the production stack: the JAX body and the
    port's stack_scale agree within 3e-5."""
    got = stack.stack_scale(torch.from_numpy(ylow), sp32)
    np.testing.assert_allclose(got.numpy(), jshift_out["base"], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("mode", ["noshiftx", "noshifty", "noshift"])
def test_a_twin_differs_from_base(jshift_out, sp32, ylow, mode):
    """A twin that ignored its mask would equal base: every twin differs
    from base by more than 1e-3, on both sides."""
    y = torch.from_numpy(ylow)
    base = probe.shift_stack(y, sp32, 1, 1)
    got = probe.shift_stack(y, sp32, *probe.SHIFT_MODES[mode])
    assert (got - base).abs().max().item() > 1e-3
    assert np.abs(jshift_out[mode] - jshift_out["base"]).max() > 1e-3


# --- tools/accpp_probe.py:127 (body :31-115) ---------------------------------
def _pp_body(spec, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b, w2c, b2c,
             w5, b5, w6, b6, blk, sel, b7,
             out_ref, xin, x1, x2, x3, x4, x5, zt, acc0, acc1):
    spec3, spec4, spec5, spec6 = spec
    accs = [acc0, acc1]
    turn = [0]

    def nacc():
        a = accs[turn[0]]
        turn[0] ^= 1
        return a

    _assemble(xin, xa, xb, xc, xd)
    x1[:] = ps._leaky(ps._dot3(xin[:], l1[:], F32)
                      + b1[0].astype(F32)).astype(F32)

    def block4(src, w_ref, b_ref, rows):
        return _block4(src, w_ref, b_ref, rows, nacc())

    x2[:, 0:WC, :] = block4(x1, w2a, b2a, TR + 5)

    def block_pair(src, w_ref, b_ref, sp, rows, dst):
        vals = []
        for A, entries in enumerate(sp):
            acc = nacc()
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
        dst[:, 0:WC, :] = jnp.concatenate(vals, axis=-1)

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3)
    block_pair(x3, w2c, b2c, spec4, TR + 3, x4)

    rows5 = TR + 2
    for p, entries in enumerate(spec5):
        acc = nacc()
        a = acc.at[0:rows5, 0:WC, 0:128]
        for g, (Dy, Dx, lanes, k0, klen) in enumerate(entries):
            part = ps._dot3(ps._gather_k(x4, rows5, WC, Dy, Dx, lanes),
                            w5[p, k0:k0 + klen, :], F32)
            if g == 0:
                a[...] = part
            else:
                a[...] += part
        x5[:, 0:WC, p * 128:(p + 1) * 128] = ps._leaky(
            a[...] + b5[0, p * 128:(p + 1) * 128].astype(F32)).astype(F32)

    rows = TR + 1
    for p, entries in enumerate(spec6):
        acc = nacc()
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
    y = None
    for Dy in (0, 1):
        for Dx in (0, 1):
            part = ps._dot3(zt[Dy:Dy + TR, Dx:Dx + TC, :],
                            sel[(Dy * 2 + Dx) * 64:(Dy * 2 + Dx + 1) * 64, :])
            y = part if y is None else y + part
    out_ref[0] = ps._leaky(y + b7[0, 0]).astype(F32)


def jpp(kp, ylow):
    arrays, spec = kp
    xcol = _xcol(ylow)
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 16), F32),
               pltpu.VMEM((TR + 6, TC + 16, 128), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 256), F32),
               pltpu.VMEM((TR + 3, TC + 16, 256), F32),
               pltpu.VMEM((TR + 2, TC + 16, 512), F32),
               pltpu.VMEM((TR + 1, TC + 16, 64), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32)]
    keys = W_KEYS + ("w5", "b5", "w6", "b6", "l7_blk", "l7_sel", "b7")
    return _call(functools.partial(_pp_body, spec),
                 [_xblk(0, 0), _xblk(0, 1), _xblk(1, 0), _xblk(1, 1)]
                 + W_SPECS + L7_IN + [_full((512, 64)), _full((256, 4)),
                                      B7_SMEM], OUT4,
                 jax.ShapeDtypeStruct((B, HL, WL, 4), F32), scratch,
                 xcol, xcol, xcol, xcol, *(arrays[k] for k in keys))


@pytest.fixture(scope="module")
def jpp_out(kp, ylow):
    return jpp(kp, ylow)


def test_accpp_pp_equals_prod_in_jax(kp, ylow, jpp_out):
    """The two alternating accumulators compute the package call's function
    (:184-187 prints max |pp - prod|): equal in interpret mode up to the f32
    rounding of sums grouped another way (the package call folds layer 7
    through l7_blk2, the body through l7_blk and l7_sel), 1e-6 at outputs
    of order 0.1."""
    arrays, spec = kp
    prod = np.asarray(ps._run_stack(_xcol(ylow), arrays, TR, TC, NY, NX, spec,
                                    interpret=True, acc_f32=True))
    np.testing.assert_allclose(jpp_out, prod, rtol=0, atol=1e-6)


def test_accpp_probe_127(jpp_out, sp32, ylow):
    """pp against the port's stack_scale_pp (the plain version of the
    tensor-core path), within 3e-5."""
    got = probe.stack_scale_pp(torch.from_numpy(ylow), sp32)
    assert got.shape == (B, HL, WL, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jpp_out, rtol=0, atol=TOL)


def test_stack_scale_pp_plain_is_the_mma_stack(sp16, ylow):
    """On the CPU pp and prod are one plain function: stack_scale's with
    layers 2-6 from the packed weights, bit for bit, in bf16; mma_layer
    with pp is mma_layer_plain."""
    y = torch.from_numpy(ylow).to(torch.bfloat16)
    assert torch.equal(probe.stack_scale_pp(y, sp16),
                       stack.stack_scale_plain(y, sp16, mma=True))
    x = torch.rand((1, 9, 11, 64)).to(torch.bfloat16)
    assert torch.equal(stack.mma_layer(x, sp16, 5, pp=True),
                       stack.mma_layer_plain(x, sp16.wm[3], sp16[4][1]))


# --- tools/l4_shift_probe.py:130 (body :40-117) ------------------------------
def _l4_body(spec, mode, xa, xb, xc, xd, l1, b1, w2a, b2a, w2b, b2b, w2c, b2c,
             out_ref, xin, x1, x2, x3, acc, x3s, x4s):
    spec3, spec4 = spec[0], spec[1]
    _assemble(xin, xa, xb, xc, xd)
    x1[:] = ps._leaky(ps._dot3(xin[:], l1[:], F32)
                      + b1[0].astype(F32)).astype(F32)
    x2[:, 0:WC, :] = _block4(x1, w2a, b2a, TR + 5, acc)

    def block_pair(src, w_ref, b_ref, sp, rows, dst, is_out, fdy, fdx,
                   src_shift=None):
        vals = []
        for A, entries in enumerate(sp):
            a = acc.at[0:rows, 0:WC, 0:128]
            for g, (Dy, Dx, lo, hi, k0, klen) in enumerate(entries):
                if fdy:
                    Dy = 0
                if fdx:
                    Dx = 0
                s = src
                if src_shift is not None and Dx == 1:
                    s, Dx = src_shift, 0
                part = ps._dot3(s[Dy:Dy + rows, Dx:Dx + WC, lo:hi],
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

    block_pair(x2, w2b, b2b, spec3, TR + 4, x3, False, False, False)
    x3_out = jnp.concatenate([x3[0:TR + 3, 0:WC, :], x3[0:TR + 3, 0:WC, :]],
                             axis=-1)[..., :256]
    if mode == "base":
        out_ref[0, :, 0:WC, :] = x3_out
    elif mode in ("l4", "zshift", "zdx"):
        block_pair(x3, w2c, b2c, spec4, TR + 3, out_ref, True,
                   mode == "zshift", mode != "l4")
    elif mode == "preshift":
        x3s[:, 0:WC + 1, :] = x3[0:TR + 4, 1:WC + 2, :]
        block_pair(x3, w2c, b2c, spec4, TR + 3, out_ref, True, False, False,
                   src_shift=x3s)
    elif mode == "stage":
        block_pair(x3, w2c, b2c, spec4, TR + 3, x4s, False, False, False)
        out_ref[0] = x4s[:]
    elif mode == "stagep":
        block_pair(x3, w2c, b2c, spec4, TR + 3, x4s, False, False, False)
        out_ref[0, :, 0:WC, :] = x4s[:, 0:WC, :]
    elif mode == "scratch":
        block_pair(x3, w2c, b2c, spec4, TR + 3, x4s, False, False, False)
        out_ref[0, :, 0:WC, :] = x3_out
    else:
        raise ValueError(mode)


def jl4(kp, ylow, mode):
    arrays, spec = kp
    xcol = _xcol(ylow)
    hb, wb = TR + 3, TC + 16
    scratch = [pltpu.VMEM((TR + 6, TC + 16, 16), F32),
               pltpu.VMEM((TR + 6, TC + 16, 128), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 256), F32),
               pltpu.VMEM((TR + 5, TC + 16, 128), F32),
               pltpu.VMEM((TR + 4, TC + 16, 256), F32),
               pltpu.VMEM((TR + 3, TC + 16, 256), F32)]
    return _call(functools.partial(_l4_body, spec, mode),
                 [_xblk(0, 0), _xblk(0, 1), _xblk(1, 0), _xblk(1, 1)]
                 + W_SPECS,
                 _vmem((1, hb, wb, 256), lambda n, i, j: (n, i, j, 0)),
                 jax.ShapeDtypeStruct((B, NY * hb, NX * wb, 256), F32),
                 scratch, xcol, xcol, xcol, xcol,
                 *(arrays[k] for k in W_KEYS))


@pytest.mark.parametrize("mode", list(probe.L4_MODES))
def test_l4_shift_probe_130(kp, sp32, ylow, mode):
    """Each mode against the port's l4_shift, within 3e-5, on every
    position that both define (tests/jax_trunc_grid.k1_defined: the body's
    (tr+3) rows and computed columns, 4 phases x 64 lanes); at least three
    quarters of the port's plane is covered."""
    jout = jl4(kp, ylow, mode)
    upto, _, keep = probe.L4_MODES[mode]
    whole = probe.l4_shift(torch.from_numpy(ylow), sp32, mode)
    assert tuple(whole.shape) == (B, 2 * HL + 14 - 2 * keep,
                                  2 * WL + 14 - 2 * keep, 64)
    assert k1_defined(keep)[2] == 256
    ref, got = jk1_on_port(jout, whole.numpy(), keep)
    assert got.size >= 0.75 * whole.numel()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_l4_shift_same_function_modes(sp32, ylow):
    """base and scratch return layer 3's whole plane, the Mosaic schedules
    l4's: stack_scale_upto(..., out="whole") at 3 and 4, bit for bit; the
    zeroed modes differ from l4 by more than 1e-3."""
    y = torch.from_numpy(ylow)
    upto = {k: stack.stack_scale_upto(y, sp32, k, out="whole")
            for k in (3, 4)}
    for mode in probe.L4_MODES:
        got = probe.l4_shift(y, sp32, mode)
        if mode in ("zshift", "zdx"):
            assert (got - upto[4]).abs().max().item() > 1e-3
        else:
            want = upto[probe.L4_MODES[mode][2]]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# --- the zero-shift function against numpy loops -----------------------------
def _r(p: int, k: int) -> int:
    return (p & ~1) | ((p + k) & 1)


def _conv_np(x, w9, zs):
    """x [N, H, W, ci] f64, w9 [9, ci, co] -> the 3x3 VALID correlation
    [N, H-2, W-2, co] with r(p, k) on the zeroed axes."""
    n, h, w, _ = x.shape
    out = np.zeros((n, h - 2, w - 2, w9.shape[2]))
    for oy in range(h - 2):
        for ox in range(w - 2):
            for t in range(9):
                dy, dx = divmod(t, 3)
                iy = _r(oy, dy) if zs & 2 else oy + dy
                ix = _r(ox, dx) if zs & 1 else ox + dx
                out[:, oy, ox] += x[:, iy, ix] @ w9[t]
    return out


def _leaky_np(v):
    return np.maximum(v, 0) + 0.1 * np.minimum(v, 0)


def test_zs_index_is_r():
    for k in range(3):
        got = stack.zs_index(11, k).tolist()
        assert got == [_r(p, k) for p in range(11)]
    # taps 0 and 2 read p itself, tap 1 the other pixel of p's cell
    assert stack.zs_index(6, 0).tolist() == list(range(6))
    assert stack.zs_index(6, 2).tolist() == list(range(6))
    assert stack.zs_index(6, 1).tolist() == [1, 0, 3, 2, 5, 4]


@pytest.mark.parametrize("zs", [0, 1, 2, 3])
@pytest.mark.parametrize("k", MID)
def test_mma_layer_plain_zero_shift(sp32, k, zs):
    """mma_layer_plain(zs) is the 3x3 correlation with r(p, k) on each
    zeroed axis (zs = 0: today's function), bias and LeakyReLU, in f32."""
    ci, co = stack.WIDTHS[k - 1]
    x = np.random.default_rng(10 + k).standard_normal((2, 9, 12, ci))
    w9 = stack.unpack_mma(sp32.wm[k - 2]).double().numpy()
    ref = _leaky_np(_conv_np(x, w9, zs) + sp32[k - 1][1].double().numpy())
    got = stack.mma_layer_plain(torch.from_numpy(x).float(), sp32.wm[k - 2],
                                sp32[k - 1][1], zs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("zs", [0, 1, 2, 3])
def test_last_layer_plain_zero_shift(sp32, zs):
    """Layer 7 in s2d layout with r(p, k) on each zeroed axis, the per-pixel
    kernel's function (last_layer with fold=False); zs = 0 is the stack's
    own layer 7 (F.conv2d, and the fold that an f32 stack runs) within
    1e-5."""
    x = np.random.default_rng(20).standard_normal((2, 10, 14, 128))
    w7, b7 = sp32[6]
    w9 = w7.double().numpy().transpose(1, 0, 2)             # [9, 128, 1]
    y = _leaky_np(_conv_np(x, w9, zs) + b7.double().numpy())[..., 0]
    ref = y.reshape(2, 4, 2, 6, 2).transpose(0, 1, 3, 2, 4).reshape(2, 4, 6, 4)
    got = stack.last_layer_plain(torch.from_numpy(x).float(), w7, b7, zs)
    assert got.shape == (2, 4, 6, 4)
    assert torch.equal(stack.last_layer(torch.from_numpy(x).float(), sp32,
                                        zs, fold=False), got)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    if zs == 0:
        xt = torch.from_numpy(x).float().permute(0, 3, 1, 2)
        plain = stack._plain_layer(xt, w7, b7, torch.float32)
        torch.testing.assert_close(got, stack.s2d(plain[:, 0, :, :, None]),
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(
            stack.last_layer(torch.from_numpy(x).float(), sp32), got,
            rtol=0, atol=1e-5)


# --- plans, C entries, routing -----------------------------------------------
def _c_variants():
    src = (ROOT / "waifu2x_torch" / "csrc" / "mma.cu").read_text()
    rows = re.findall(r"^\s*W2X_MMA_VARIANT\(([^)]*)\)", src, re.M)
    out = {}
    for row in rows:
        layer, ci, co, kc, st, zs, pp = (int(v) for v in row.split(","))
        assert stack.WIDTHS[layer] == (ci, co)
        out[(ci, co, zs, bool(pp))] = (kc, st)
    return out


def test_variant_table_matches_the_c_side():
    """ops/stack.py:_MMA_VARIANTS lists exactly the (layer, zs, pp) that
    csrc/mma.cu instantiates, with the same chunk plans: every layer under
    zs 1, 2, 3 and with pp."""
    assert _c_variants() == stack._MMA_VARIANTS
    assert len(stack._MMA_VARIANTS) == 20


@pytest.mark.parametrize("key", sorted(stack._MMA_VARIANTS))
def test_variant_plan_fits_shared_memory(key):
    ci, co, zs, pp = key
    plan = stack.mma_plan(ci, co, zs, pp)
    assert (plan.kc, plan.stages) == stack._MMA_VARIANTS[key]
    assert (plan.zs, plan.pp) == (zs, pp)
    copies = {0: 1, 1: 2, 2: 2, 3: 4}[zs]
    ring = plan.stages * plan.kc // 8 * (copies * plan.win_stride
                                         + 9 * co) * 16
    if pp:
        half = 256 * (co + 16)
        assert plan.smem_bytes == max(ring, half) + half
    else:
        assert plan.smem_bytes == max(ring, 256 * (2 * co + 16))
    assert plan.smem_bytes <= stack.SMEM_MAX


def test_variant_plan_numbers():
    """The shared memory of the largest variants, by mma_plan's formula."""
    sm = {key: stack.mma_plan(*key).smem_bytes for key in (
        (32, 32, 3, False), (32, 64, 3, False), (64, 64, 3, False),
        (128, 128, 3, False), (64, 128, 1, False), (64, 128, 3, False),
        (64, 128, 0, True))}
    assert sm == {(32, 32, 3, False): 102912, (32, 64, 3, False): 121344,
                  (64, 64, 3, False): 119808, (128, 128, 3, False): 156672,
                  (64, 128, 1, False): 231936, (64, 128, 3, False): 156672,
                  (64, 128, 0, True): 226560}
    assert stack.mma_plan(64, 128, 3).kc == 16


@pytest.mark.parametrize("zs,pp", [(3, True), (4, False), (1, True)])
def test_unbuilt_variants_are_refused(sp32, zs, pp):
    with pytest.raises(ValueError):
        stack.mma_plan(64, 64, zs, pp)
    with pytest.raises(ValueError):
        stack.mma_layer(torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16),
                        sp32, 4, zs=zs, pp=pp)


def test_ctypes_signatures_of_the_new_entries():
    """The C entries of the variants (and the fold, which takes the mask
    next to last) against their argtypes."""
    csrc = ROOT / "waifu2x_torch" / "csrc"
    decl = {}
    for name in ("mma.cu", "stack.cu", "l7.cu"):
        for fn, args in re.findall(r"\bint (w2x_\w+)\(([^)]*)\)",
                                   (csrc / name).read_text()):
            decl[fn] = [a.split()[-1].lstrip("*") for a in args.split(",")]
    for lib, fn in (("mma", "w2x_mma_layer_variant"),
                    ("stack", "w2x_stack_last_zs"), ("l7", "w2x_l7_fold")):
        assert len(stack._ARGTYPES[lib][fn]) == len(decl[fn])
    assert decl["w2x_mma_layer_variant"][:4] == ["bf16", "layer", "zs", "pp"]
    assert decl["w2x_stack_last_zs"][:2] == ["bf16", "zs"]
    assert decl["w2x_l7_fold"][-2:] == ["zs", "stream"]


class _FakeLib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def _fake_launcher(calls, bf16=True):
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "probe", None, 0
    run.libs = {name: _FakeLib(calls)
                for name in ("stack", "mma", "l6", "l7", "l1", "mma_tf32")}
    run.bf16, run.stream = int(bf16), 0
    return run


@pytest.mark.parametrize("zs,pp", [(1, False), (2, False), (3, False),
                                   (0, True)])
def test_variant_launch_routing(sp16, zs, pp):
    """A whole stack under a variant: layer 1 on csrc/l1.cu, layers 2-6
    on w2x_mma_layer_variant with the variant's plan, layer 7 folded on
    w2x_l7_fold as in stack_scale (under zs with the mask), each counted
    where its kernel is: MID_LAUNCHES "mma_zs" / "mma_pp", L7_LAUNCHES
    "fold" (none under L6_LAUNCHES "last_zs"), and 7 launches of kind
    "probe"."""
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls)
    x = torch.zeros(1, dtype=torch.bfloat16)
    n, hl, wl = 2, 10, 12
    for k in range(7):
        run.layer(k, False, x, sp16, x, n, hl, wl, zs=zs if k else 0,
                  pp=pp and 1 <= k <= 5)
    names = [fn for fn, _ in calls]
    assert names == ["w2x_l1"] + ["w2x_mma_layer_variant"] * 5 + [
        "w2x_l7_fold"]
    assert stack.L7_LAUNCHES == {"fold": 1, "fold_f32": 0, "cell": 0,
                                 "pixel": 0}
    for k, (_, args) in list(enumerate(calls))[1:6]:
        plan = stack.mma_plan(*stack.WIDTHS[k], zs, pp)
        # (bf16, layer, zs, pp, x, wp, b, y, n, hin, win, smem_bytes, stream)
        assert args[:4] == (1, k, zs, int(pp))
        assert args[8:] == (n, 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k,
                            plan.smem_bytes, 0)
    # (bf16, x6, w, b, y, n, hl, wl, out_mode, uvp, cmap, dense_tc,
    #  tr, tc, ny, nx, zs, stream)
    assert calls[6][1][0] == 1 and calls[6][1][5:9] == (n, hl, wl, 0)
    assert calls[6][1][16:] == (zs, 0)
    assert stack.LAUNCHES == stack.KERNEL_LAUNCHES["probe"] == 7
    assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                  "mma_zs": 0 if pp else 5,
                                  "mma_pp": 5 if pp else 0, "mma_tf32": 0,
                                  "mma_resident": 0, "mma_split": 0,
                                  "mma_tile": 0}
    assert stack.L6_LAUNCHES["last_zs"] == 0
    assert stack.L6_LAUNCHES["direct"] == 1
    stack.reset_launches()


def test_f32_variants_are_refused(sp32):
    """f32 layers 2-6 are FFMA: no variant is launched for them, nor for
    layer 1 or a two-accumulator layer 7; layer 7 under a mask takes f32,
    folded (with fold=False per pixel)."""
    calls = []
    run = _fake_launcher(calls, bf16=False)
    x = torch.zeros(1)
    for k, zs, pp in ((2, 1, False), (3, 0, True), (6, 0, True),
                      (0, 1, False)):
        with pytest.raises(ValueError, match="no variant"):
            run.layer(k, False, x, sp32, x, 1, 10, 12, zs=zs, pp=pp)
    assert not calls
    run.layer(6, False, x, sp32, x, 1, 10, 12, zs=3)
    run.layer(6, False, x, sp32, x, 1, 10, 12, zs=3, fold=False)
    assert [fn for fn, _ in calls] == ["w2x_l7_fold", "w2x_stack_last_zs"]
    assert calls[0][1][0] == 0 and calls[0][1][16] == 3
    assert calls[1][1][:2] == (0, 3)
    stack.reset_launches()


def test_cpu_probe_stacks_launch_nothing(sp32, ylow):
    stack.reset_launches()
    y = torch.from_numpy(ylow)
    probe.stack_scale_pp(y, sp32)
    for fx, fy in probe.SHIFT_MODES.values():
        probe.shift_stack(y, sp32, fx, fy)
    for mode in probe.L4_MODES:
        probe.l4_shift(y, sp32, mode)
    assert stack.LAUNCHES == 0 and not any(stack.MID_LAUNCHES.values())
    assert not any(stack.L6_LAUNCHES.values())


def test_bad_arguments(sp32, ylow):
    y = torch.from_numpy(ylow)
    with pytest.raises(ValueError):
        probe.shift_stack(y, sp32, 2, 1)
    with pytest.raises(ValueError):
        probe.l4_shift(y, sp32, "bogus")
    with pytest.raises(ValueError, match="packed weights"):
        probe.shift_stack(y, tuple(sp32), 0, 0)


# --- the tools ---------------------------------------------------------------
@pytest.mark.parametrize("tool,argv,n_rows", [
    (accpp_probe, [], 3),
    (shift_cost_probe, shift_cost_probe.MODES, 4),
    (l4_shift_probe, l4_shift_probe.MODES, 8)])
def test_tool_main_on_cpu(tool, argv, n_rows, capsys):
    rows = []
    assert tool.main(list(argv) + ["--device", "cpu", "--batch", "1",
                                   "--size", "32", "--tile", "16", "32",
                                   "--iters", "1"], rows) == 0
    assert len(rows) == n_rows
    out = capsys.readouterr().out
    assert "no device time" in out
    assert all(r["bound_ms"] > 0 and r["plans"] for r in rows)
    if tool is accpp_probe:
        assert rows[1]["max_abs_err"] == 0
        assert "max |pp - prod| = 0.0" in out


def _jax_default(path: str, name: str) -> list:
    """The list after `name = sys.argv[1:] or` in a JAX tool's source."""
    src = (ROOT / "tools" / path).read_text()
    m = re.search(rf"^{name} = sys\.argv\[1:\] or (\[[^\]]*\])", src, re.M)
    return ast.literal_eval(m.group(1))


def test_tool_modes_are_the_jax_tools():
    assert accpp_probe.DEFAULT == _jax_default("accpp_probe.py", "which")
    assert shift_cost_probe.DEFAULT == _jax_default("shift_cost_probe.py",
                                                    "args")
    assert l4_shift_probe.DEFAULT == _jax_default("l4_shift_probe.py",
                                                  "modes")
    src = (ROOT / "tools" / "shift_cost_probe.py").read_text()
    m = re.search(r"^MODES = (\{[^}]*\})", src, re.M)
    assert ast.literal_eval(m.group(1)) == probe.SHIFT_MODES
    src = (ROOT / "tools" / "l4_shift_probe.py").read_text()
    body_modes = re.findall(r'if mode == "(\w+)"', src)
    assert body_modes == l4_shift_probe.MODES
    assert set(accpp_probe.MODES) == {"prod", "pp"}
