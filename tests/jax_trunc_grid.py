"""The small grid and the shared pieces of the JAX tool bodies that the
probe tests restate (tests/test_torch_trunc.py, tests/test_torch_shift.py):
tile (8, 16), 2 x 2 cells, one image, f32; BlockSpecs of the 16-lane
im2col array and of the JAX package's weights, a Pallas call in interpret
mode, layer 2's four-block product, the window assembly, and the map of
k1_forensics' packed output windows onto the port's whole planes."""

import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_tpu.ops import pallas_stack as ps
from waifu2x_torch.ops import stack

B, TR, TC = 1, 8, 16
HL, WL = 2 * TR, 2 * TC
NY, NX = HL // TR, WL // TC
WC = TC + 8
F32 = jnp.float32
TOL = 3e-5


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _full(shape):
    return _vmem(shape, lambda n, i, j: (0,) * len(shape))


def _xblk(di, dj):
    return _vmem((1, TR, TC, 16), lambda n, i, j: (n, i + di, j + dj, 0))


W_SPECS = [_full((16, 128)), _full((1, 128)), _full((4, 128, 128)),
           _full((1, 128)), _full((2, 384, 128)), _full((1, 256)),
           _full((2, 768, 128)), _full((1, 256))]
W_KEYS = ("l1", "b1", "w2a", "b2a", "w2b", "b2b", "w2c", "b2c")


def _call(body, in_specs, out_spec, out_shape, scratch, *args):
    return np.asarray(pl.pallas_call(
        body, grid=(B, NY, NX), in_specs=in_specs, out_specs=out_spec,
        out_shape=out_shape, scratch_shapes=scratch, interpret=True)(*args))


def _block4(src, w_ref, b_ref, rows, acc):
    a = acc.at[0:rows, 0:WC, 0:128]
    a[...] = ps._dot3(src[0:rows, 0:WC, :], w_ref[0], F32)
    a[...] += ps._dot3(src[0:rows, 1:WC + 1, :], w_ref[1], F32)
    a[...] += ps._dot3(src[1:rows + 1, 0:WC, :], w_ref[2], F32)
    a[...] += ps._dot3(src[1:rows + 1, 1:WC + 1, :], w_ref[3], F32)
    return ps._leaky(a[...] + b_ref[0].astype(F32)).astype(F32)


def _assemble(xin, xa, xb, xc, xd):
    xin[0:TR, 0:TC, :] = xa[0]
    xin[0:TR, TC:TC + 16, :] = xb[0][:, 0:16, :]
    xin[TR:TR + 6, 0:TC, :] = xc[0][0:6, :, :]
    xin[TR:TR + 6, TC:TC + 16, :] = xd[0][0:6, 0:16, :]


def k1_defined(upto: int):
    """(r, c, lanes) the JAX body writes from layers that read only written
    scratch: its (tr+3) rows, tc+8 columns less the last k-2 from layer 3
    on, and the 9 taps (k = 0) or 4 phases x C_k lanes."""
    cols = WC - max(0, upto - 2)
    lanes = 9 if upto == 0 else 4 * stack.WIDTHS[upto - 1][1]
    return TR + 3, cols, lanes


def jk1_on_port(jout: np.ndarray, whole: np.ndarray, upto: int):
    """The JAX packed windows and the port's whole plane on the positions
    both define -> (jax values, port values), 1-d."""
    rows, cols, lanes = k1_defined(upto)
    hb, wb = TR + 3, TC + 16
    n, hk, wk, ck = whole.shape
    got, ref = [], []
    for b in range(n):
        for i in range(NY):
            for j in range(NX):
                blk = jout[b, i * hb:i * hb + rows, j * wb:j * wb + cols,
                           :lanes]
                for r in range(rows):
                    for c in range(cols):
                        R, C = i * TR + r, j * TC + c
                        for lane in range(lanes):
                            if upto == 0:   # tap dy*3+dx of the window
                                y, x, ch = R + lane // 3, C + lane % 3, 0
                            else:           # phase (a, b), channel ch
                                p, ch = divmod(lane, ck)
                                y, x = 2 * R + p // 2, 2 * C + p % 2
                            if y < hk and x < wk:
                                ref.append(blk[r, c, lane])
                                got.append(whole[b, y, x, ch])
    return np.array(ref), np.array(got)
