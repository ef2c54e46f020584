"""Layers 2-6 on the tensor cores (waifu2x_torch/csrc/mma.cu) as far as the
CPU reaches them: the weight packer, the plain version from the packed
weights, the shared-memory plans the C entries are launched with (the
persistent kernel's and the tile kernel's), the persistent kernel's walk
over the tiles and an emulation of its staging, products and stores, the
dispatch by dtype and route and its launch counts, and the mma_chain
probe's plain version.

Tolerances: in f32 the plain version from the packed weights is held to
1e-5 against F.conv2d (a wrong tap or channel order is off by the size of
the values); in bf16 to one bf16 ulp at the output's magnitude, because the
two sum the same exact products in another order and a sum next to a
rounding boundary may land on either side; where the terms cancel to an
output near zero the f32 sums' own spread (1e-5 for values of order 1) is
more than that ulp and is what is allowed. Whole stacks are held against
the JAX package at the bars of tests/test_torch_stack.py: f32 3e-5, bf16
storage >= 50 dB (peak 1) against f32. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER, as_numpy, init_params
from waifu2x_tpu.ops.convstack import convert_plane as jconvert_plane
from waifu2x_tpu.ops.pallas_stack import prep_params as jprep_params
from waifu2x_tpu.ops.pallas_stack import stack_scale as jstack_scale
from waifu2x_torch.models.weights import load_model_json, params_from_numpy
from waifu2x_torch.ops import stack
from waifu2x_torch.ops.s2d import d2s, pack_mma, unpack_mma
from waifu2x_torch.tools import mma_probe

torch.set_num_threads(2)

MID = list(range(2, 7))                       # the layers the kernel runs
ODD_SHAPES = [(1, 27, 38), (2, 37, 53), (1, 5, 300)]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), WAIFU2X_7LAYER))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.fixture(scope="module")
def sp16(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                             "cpu")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 (8 significant bits) at |v|."""
    mag = v.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("k", MID)
def test_pack_mma_round_trip_and_tap_order(params_np, k):
    w = torch.from_numpy(params_np[k - 1]["w"].copy())       # [3, 3, ci, co]
    ci, co = stack.WIDTHS[k - 1]
    wp = pack_mma(w)
    assert wp.shape == (ci // 8, 9, co, 8) and wp.is_contiguous()
    # out[c8, dy*3 + dx, o, j] == w[dy, dx, 8*c8 + j, o]
    assert wp[ci // 8 - 1, 5, 3, 6] == w[1, 2, ci - 2, 3]
    assert wp[0, 6, co - 1, 0] == w[2, 0, 0, co - 1]
    torch.testing.assert_close(unpack_mma(wp), w.reshape(9, ci, co),
                               rtol=0, atol=0)
    # a chunk of 16 input channels is one contiguous run of the packed array
    chunk = wp.reshape(-1)[:2 * 9 * co * 8].reshape(2, 9, co, 8)
    torch.testing.assert_close(unpack_mma(chunk), w.reshape(9, ci, co)[:, :16],
                               rtol=0, atol=0)


def test_pack_mma_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_mma(torch.zeros(3, 3, 12, 8))
    with pytest.raises(ValueError, match="kh, kw, ci, co"):
        pack_mma(torch.zeros(9, 16, 8))


def test_prep_params_packs_the_mid_layers(params_np, sp16, sp32):
    for sp, dtype in ((sp16, torch.bfloat16), (sp32, torch.float32)):
        assert len(sp.wm) == 5
        for k, wp in zip(MID, sp.wm):
            assert wp.dtype == dtype
            # the packed weights are the layer's own, in its storage dtype
            torch.testing.assert_close(
                unpack_mma(wp).permute(1, 0, 2).contiguous(), sp[k - 1][0],
                rtol=0, atol=0)


@pytest.mark.parametrize("shape", ODD_SHAPES)
@pytest.mark.parametrize("k", MID)
def test_mma_layer_plain_matches_plain_layer_f32(sp32, rng, k, shape):
    ci, _ = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((*shape, ci), dtype=np.float32))
    got = stack.mma_layer_plain(x, sp32.wm[k - 2], sp32[k - 1][1])
    ref = stack._plain_layer(x.permute(0, 3, 1, 2), *sp32[k - 1],
                             torch.float32).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (shape[0], shape[1] - 2, shape[2] - 2,
                                      stack.WIDTHS[k - 1][1])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", MID)
def test_mma_layer_plain_matches_plain_layer_bf16(sp16, rng, k):
    """bf16 storage: the products are exact in f32 on both sides and only
    the order of the f32 sums differs, so the stored outputs agree within
    one bf16 ulp at their own magnitude (or the f32 sums' spread, 1e-5,
    where the terms cancel), and nearly all are equal."""
    ci, _ = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((2, 19, 23, ci),
                                             dtype=np.float32)
                         ).to(torch.bfloat16)
    got = stack.mma_layer(x, sp16, k)        # a CPU tensor: the plain version
    assert got.dtype == torch.bfloat16
    ref = stack._plain_layer(x.float().permute(0, 3, 1, 2), *sp16[k - 1],
                             torch.bfloat16).permute(0, 2, 3, 1)
    diff = (got.float() - ref).abs()
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.abs()))
    assert bool((diff <= ulp.clamp_min(1e-5)).all())
    assert (diff > 0).float().mean().item() < 0.02


@pytest.mark.parametrize("hl,wl", [(16, 16), (13, 22), (9, 9), (5, 31)])
def test_scale_stack_from_packed_weights_matches_convert_plane(
        params_np, sp32, rng, hl, wl):
    ylow = rng.random((2, hl, wl), dtype=np.float32)
    up = np.repeat(np.repeat(ylow, 2, axis=1), 2, axis=2)
    ref = np.asarray(jconvert_plane(jnp.asarray(up), params_np,
                                    precision="highest"))
    got = d2s(stack.stack_scale_plain(torch.from_numpy(ylow), sp32,
                                      mma=True))[..., 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


def test_scale_stack_from_packed_weights_matches_pallas_interpret(
        params_np, sp32, rng):
    ylow = rng.random((2, 13, 22), dtype=np.float32)
    kp, spec = jprep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jstack_scale(jnp.asarray(ylow), kp, spec, tile=(16, 16),
                                  interpret=True))
    got = stack.stack_scale_plain(torch.from_numpy(ylow), sp32, mma=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("n,h,w", [(2, 16, 24), (1, 27, 38), (1, 5, 300)])
def test_noise_stack_from_packed_weights_matches_convert_plane(
        params_np, sp32, rng, n, h, w):
    y = rng.random((n, h, w), dtype=np.float32)
    ref = np.asarray(jconvert_plane(jnp.asarray(y), params_np,
                                    precision="highest"))
    got = stack.stack_noise_plain(torch.from_numpy(y), sp32, mma=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)
    if h % 2 == 0 and w % 2 == 0:
        s2 = stack.stack_noise_s2d_plain(torch.from_numpy(y), sp32, mma=True)
        np.testing.assert_allclose(d2s(s2)[..., 0].numpy(), ref, rtol=0,
                                   atol=3e-5)


@pytest.mark.parametrize("model,scale", [("scale2.0x", True),
                                         ("noise1", False)])
def test_bf16_stack_from_packed_weights_fidelity(rng, model, scale):
    """The shipped weights in bf16 storage with layers 2-6 from the packed
    weights: >= 50 dB against f32, and within 2^-6 of the bf16 stack with
    F.conv2d layers (a tie flips one bf16 unit of some activation)."""
    params = load_model_json(Path(__file__).resolve().parents[1] / "models"
                             / f"{model}_demo.json")
    yy, xx = np.mgrid[0:24, 0:40].astype(np.float32)
    y = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
         + 0.02 * rng.standard_normal((24, 40))).astype(np.float32)[None]
    plain = stack.stack_scale_plain if scale else stack.stack_noise_s2d_plain
    y32 = plain(torch.from_numpy(y),
                stack.prep_params(params, torch.float32, "cpu"))
    sp = stack.prep_params(params, torch.bfloat16, "cpu")
    y16 = torch.from_numpy(y).to(torch.bfloat16)
    got = plain(y16, sp, mma=True)
    assert got.dtype == torch.bfloat16
    mse = torch.mean((got.double() - y32.double()) ** 2).item()
    assert 10 * np.log10(1.0 / mse) >= 50.0
    assert (got.float() - plain(y16, sp).float()).abs().max() <= 2.0 ** -6


@pytest.mark.parametrize("k", MID)
def test_mma_plan_fits_shared_memory(k):
    """The persistent kernel's plan: the resident weights, the ring of
    window slots with their two mbarriers each, the weights' mbarrier and
    128 bytes of alignment fit in the 232,448 bytes of one block an SM;
    the epilogue stores from the registers and takes no shared memory; two
    consumer groups where a warpgroup's two m64 accumulators (2 x n / 2
    registers a thread) fit, that is at most 64 outputs a block."""
    ci, co = stack.WIDTHS[k - 1]
    plan = stack.mma_plan(ci, co)
    kc, slots = plan.kc, plan.stages
    assert plan.tile == (16, 16) and plan.threads == 544   # + producer warp
    assert (kc, plan.zs, plan.pp) == (stack._MMA_CHUNK[(ci, co)][0], 0, False)
    assert kc % 16 == 0 and ci % kc == 0
    # each k8 slab of a window (18 x 18 pixels of 16 bytes, as one TMA box
    # lands) starts 128-byte aligned
    assert plan.win_stride >= 18 * 18 and plan.win_stride * 16 % 128 == 0
    slot = kc // 8 * plan.win_stride * 16
    halves = 2 if plan.route == "split" else 1
    assert plan.resident_bytes == 9 * ci * co * 2 // halves
    assert 3 <= slots <= 8
    assert plan.smem_bytes == (128 + plan.resident_bytes + 8
                               + slots * (slot + 16))
    assert plan.smem_bytes <= stack.SMEM_MAX == 232448
    assert plan.groups == (2 if co // halves <= 64 else 1)
    # as many slots as fit, up to 8; a group's whole tile at least
    assert slots == 8 or plan.smem_bytes + slot + 16 > stack.SMEM_MAX
    assert slots >= ci // kc
    # only the windows stream: each chunk's once a tile (a half's once)
    assert plan.l2_tile_bytes == halves * ci // 8 * 18 * 18 * 16


@pytest.mark.parametrize("k", MID)
def test_mma_plan_route_follows_the_widths(k):
    """Layers 2-5 keep all their weights (18 / 37 / 74 / 147 KB) beside a
    ring of 3 slots; layer 6's 295 KB do not fit, so its outputs are split
    in two halves of 147 KB each, which do; the tile kernel stages 39-378
    KB a tile from L2 where the persistent kernel stages 21-166 KB."""
    ci, co = stack.WIDTHS[k - 1]
    plan = stack.mma_plan(ci, co)
    slot = plan.kc // 8 * plan.win_stride * 16
    whole = 128 + 9 * ci * co * 2 + 3 * (slot + 16) + 8
    assert plan.route == ("resident" if whole <= stack.SMEM_MAX else "split")
    assert plan.route == ("split" if k == 6 else "resident")
    if plan.route == "split":
        assert 128 + 9 * ci * co + 3 * (slot + 16) + 8 <= stack.SMEM_MAX
    tile = stack.mma_plan(ci, co, persistent=False)
    assert tile.route == "tile"
    assert (tile.l2_tile_bytes, plan.l2_tile_bytes) == {
        2: (39168, 20736), 3: (57600, 20736), 4: (115200, 41472),
        5: (188928, 41472), 6: (377856, 165888)}[k]


@pytest.mark.parametrize("k", MID)
def test_mma_tile_plan_fits_shared_memory(k):
    """The tile kernel's plan (persistent=False: the yardstick and every
    probe variant's base)."""
    ci, co = stack.WIDTHS[k - 1]
    plan = stack.mma_plan(ci, co, persistent=False)
    kc, stages = plan.kc, plan.stages
    assert plan.tile == (16, 16) and plan.threads == 512
    # whole k16 steps, whole chunks, at most 8 channel groups a chunk, and
    # no more buffers than chunks
    assert kc % 16 == 0 and ci % kc == 0 and kc <= 64
    assert stages == 1 or 2 <= stages <= ci // kc
    k8c = kc // 8
    # the k8 stride holds the 18 x 18 window and spreads a quarter-warp's
    # 8 copies (k8c channel groups of 8 / k8c pixels) over 8 bank groups
    assert plan.win_stride >= 18 * 18
    groups = {(g * plan.win_stride + p) % 8
              for g in range(k8c) for p in range(8 // k8c)}
    assert len(groups) == 8
    ring = stages * k8c * (plan.win_stride + 9 * co) * 16
    assert plan.smem_bytes == max(ring, 256 * (2 * co + 16))
    assert plan.smem_bytes <= stack.SMEM_MAX == 232448
    # two blocks of a CO <= 64 layer fit one SM (228 KB, 1 KB a block kept)
    if co <= 64:
        assert 2 * (plan.smem_bytes + 1024) <= 233472
    # the window and all 9 taps' weights, once a chunk
    assert plan.l2_tile_bytes == ci // kc * k8c * (18 * 18 + 9 * co) * 16


def test_persistent_plan_matches_mma_cu():
    """The constants and the chunk table that mma_plan shares with
    csrc/mma.cu, read from the source."""
    src = (Path(__file__).resolve().parents[1] / "waifu2x_torch" / "csrc"
           / "mma.cu").read_text()
    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+)", src).group(1))
    assert const("RS") == stack._RES_STRIDE
    assert const("RES_CONSUMERS") + 32 == stack._RES_THREADS
    assert "RES_THREADS = RES_CONSUMERS + 32" in src
    assert const("SMEM_MAX") == stack.SMEM_MAX
    assert "SLOTS = FIT < 8 ? FIT : 8" in src and stack._RES_SLOTS == 8
    table = re.findall(r"W2X_MMA_CASE\((\d+), (\d+), (\d+), (\d)\)", src)
    alone = re.findall(r"W2X_MMA_PERSISTENT\((\d+), (\d+), (\d+)\)", src)
    assert {**{(int(ci), int(co)): (int(kc), int(st))
               for ci, co, kc, st in table},
            **{(int(ci), int(co)): (int(kc), None)
               for ci, co, kc in alone}} == stack._MMA_CHUNK


@pytest.mark.parametrize("ci,co", [(32, 48), (1, 32), (128, 1), (64, 32),
                                   (128, 256)])
def test_mma_plan_rejects(ci, co):
    """Only vgg_7's five mid-layer widths and UpCUNet's 128 -> 64 have a
    tensor-core kernel (UpCUNet's 128 -> 256 runs on cuDNN)."""
    with pytest.raises(ValueError):
        stack.mma_plan(ci, co)


GRID_SHAPES = [(1, 27, 38), (2, 37, 53), (1, 5, 300), (16, 1036, 1036),
               (256, 268, 268), (3, 18, 18), (1, 19, 35)]


@pytest.mark.parametrize("n,hin,win", GRID_SHAPES)
def test_mma_grid_covers_ragged_shapes(n, hin, win):
    nty, ntx, blocks = stack.mma_grid(n, hin, win)
    assert blocks == n * nty * ntx
    for tiles, out in ((nty, hin - 2), (ntx, win - 2)):
        assert 16 * tiles >= out > 16 * (tiles - 1)


@pytest.mark.parametrize("k", MID)
@pytest.mark.parametrize("n,hin,win", GRID_SHAPES)
def test_mma_walk_visits_every_tile_once(n, hin, win, k):
    """The persistent kernel's walk (a mirror of launch_mma and the
    kernel's loop) on a 132-SM card: every tile of the shape, each half of
    it under the split, is computed by exactly one block; no block is
    idle, none more than the card holds at once; blocks share the work to
    one unit; under the split each block keeps one half (its resident
    weights), and blocks 2p and 2p + 1 take the two halves of the same
    tiles in the same order, so the second read of a window is an L2 hit."""
    plan = stack.mma_plan(*stack.WIDTHS[k - 1])
    tiles = stack.mma_grid(n, hin, win)[2]
    walk = stack.mma_walk(tiles, plan, sms=132)
    halves = 2 if plan.route == "split" else 1
    assert 0 < len(walk) <= 132
    assert len(walk) % halves == 0
    seen = sorted(unit for block in walk for unit in block)
    assert seen == [(t, h) for t in range(tiles) for h in range(halves)]
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
    assert min(map(len, walk)) >= 1
    for b, block in enumerate(walk):
        assert {h for _, h in block} == {b % halves}
        assert [t for t, _ in block] == sorted(t for t, _ in block)
    if halves == 2:
        for p in range(0, len(walk), 2):
            assert [t for t, _ in walk[p]] == [t for t, _ in walk[p + 1]]


def test_mma_walk_refuses_the_tile_kernel():
    with pytest.raises(ValueError):
        stack.mma_walk(10, stack.mma_plan(32, 32, persistent=False))


def _emulate_persistent(x, wp, b, plan):
    """csrc/mma.cu's persistent kernel, emulated in float64 from its
    addresses: every window chunk landed as the TMA boxes land it (k8 slabs
    of [18 rows][18 cols][8], RS apart, zero past the plane), the block's
    resident weights as the producer's bulk copies lay them ([ci/8][9]
    [nco][8], this half's rows), the A and B operands read through the
    descriptors' strides (LBO / SBO) at every (chunk, tap, k16) step, the
    accumulator fragment of each thread, and the epilogue's quad transpose
    and 16-byte stores. Returns the f64 output before the rounding and how
    often each output element was stored."""
    n, hin, win, ci = x.shape
    co = b.shape[0]
    kc, rs = plan.kc, plan.win_stride
    k8c, nchunk = kc // 8, ci // kc
    halves = 2 if plan.route == "split" else 1
    nco = co // halves
    hout, wout = hin - 2, win - 2
    nty, ntx, tiles = stack.mma_grid(n, hin, win)
    xs = x.double().numpy()
    wsrc = wp.double().numpy().reshape(-1)        # [ci/8][9][co][8] flat
    y = np.zeros((n, hout, wout, co))
    stored = np.zeros((n, hout, wout, co), dtype=np.int64)
    # element offsets (2 bytes) of an operand from its descriptor fields
    m, kk = np.arange(64)[:, None], np.arange(16)[None, :]
    a_rel = (m // 8) * 18 * 8 + (m % 8) * 8 + (kk // 8) * rs * 8 + kk % 8
    nn = np.arange(nco)[:, None]
    b_rel = (nn // 8) * 64 + (nn % 8) * 8 + (kk // 8) * 9 * nco * 8 + kk % 8
    for block in stack.mma_walk(tiles, plan):
        for t, h in block:
            # the resident weights of half h
            res = np.concatenate([
                wsrc[(r * co + h * nco) * 8:(r * co + h * nco + nco) * 8]
                for r in range(ci // 8 * 9)])
            img, rem = divmod(t, nty * ntx)
            oy0, ox0 = 16 * (rem // ntx), 16 * (rem % ntx)
            acc = np.zeros((4, 64, nco))
            for c in range(nchunk):
                slot = np.zeros(k8c * rs * 8)
                for k8 in range(k8c):
                    box = np.zeros((18, 18, 8))
                    src = xs[img, oy0:oy0 + 18, ox0:ox0 + 18,
                             c * kc + 8 * k8:c * kc + 8 * k8 + 8]
                    box[:src.shape[0], :src.shape[1]] = src
                    slot[k8 * rs * 8:k8 * rs * 8 + 18 * 18 * 8] = box.ravel()
                wc = c * k8c * 9 * nco * 8
                for wg in range(4):
                    a_off = ((8 * (wg >> 1)) * 18 + 8 * (wg & 1)) * 8
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for ks in range(kc // 16):
                            a = slot[a_off + (2 * ks * rs + dy * 18 + dx) * 8
                                     + a_rel]
                            bm = res[wc + (2 * ks * 9 + tap) * nco * 8
                                     + b_rel]
                            acc[wg] += a @ bm.T
            # epilogue: thread (w4, lane) of warpgroup wg holds rows
            # 16 w4 + lane / 4 (+ 8), columns 8j + 2 quad + {0, 1}
            for wg in range(4):
                ty8, tx8 = wg >> 1, wg & 1
                for w4 in range(4):
                    for hh in range(2):
                        oy = oy0 + 8 * ty8 + 2 * w4 + hh
                        words = {}
                        for lane in range(32):
                            q, r = lane & 3, 16 * w4 + (lane >> 2) + 8 * hh
                            for j in range(nco // 8):
                                ch = 8 * j + 2 * q
                                v = acc[wg, r, ch:ch + 2] + b[h * nco + ch:
                                                             h * nco + ch + 2]
                                words[lane, j] = np.where(v > 0, v, 0.1 * v)
                        for g in range(nco // 32):
                            wd = {(ln, jj): words[ln, 4 * g + jj]
                                  for ln in range(32) for jj in range(4)}
                            for mk in (1, 2):
                                new = dict(wd)
                                for ln in range(32):
                                    q = ln & 3
                                    for jj in range(4):
                                        if jj & mk:
                                            continue
                                        # lane ln sends, its partner gets
                                        send = wd[ln, jj] if q & mk else \
                                            wd[ln, jj | mk]
                                        peer = ln ^ mk
                                        if peer & 3 & mk:
                                            new[peer, jj] = send
                                        else:
                                            new[peer, jj | mk] = send
                                wd = new
                            for lane in range(32):
                                ox = ox0 + 8 * tx8 + (lane >> 2)
                                if oy < hout and ox < wout:
                                    c0 = h * nco + 8 * (4 * g + (lane & 3))
                                    y[img, oy, ox, c0:c0 + 8] = np.concatenate(
                                        [wd[lane, jj] for jj in range(4)])
                                    stored[img, oy, ox, c0:c0 + 8] += 1
    return y, stored


@pytest.mark.parametrize("k", MID)
def test_persistent_kernel_emulation_gives_the_layer(sp32, rng, k):
    """The persistent kernel's addresses and data flow, emulated in float64
    on a ragged shape with more tiles than one: every output stored once,
    equal to the layer (bias and LeakyReLU of the 3x3 correlation) to
    float64 rounding."""
    ci, co = stack.WIDTHS[k - 1]
    x = torch.from_numpy(rng.standard_normal((1, 19, 35, ci),
                                             dtype=np.float32))
    wp, b = sp32.wm[k - 2], sp32[k - 1][1]
    got, stored = _emulate_persistent(x, wp, b.double().numpy(),
                                      stack.mma_plan(ci, co))
    assert (stored == 1).all()
    w = unpack_mma(wp).double().numpy()               # [9, ci, co]
    xd = x.double().numpy()
    ref = sum(xd[:, t // 3:t // 3 + 17, t % 3:t % 3 + 33] @ w[t]
              for t in range(9)) + b.double().numpy()
    ref = np.where(ref > 0, ref, 0.1 * ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def test_mma_chain_plain_matches_numpy(rng):
    x = rng.standard_normal((256, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 128, 128)) * 0.1).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wp = stack.pack_chain(wt)
    assert wp.shape == (3, 16, 1, 128, 8)
    ref = sum(xt.float().numpy().astype(np.float64)
              @ wt[p].float().numpy().astype(np.float64) for p in range(3))
    got = stack.mma_chain(xt, wp)            # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (256, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["rows", "cols", "dtype", "packing"])
def test_mma_chain_rejects_bad_input(case):
    x = torch.zeros(256, 128, dtype=torch.bfloat16)
    wp = torch.zeros(2, 16, 1, 128, 8, dtype=torch.bfloat16)
    bad = {"rows": (ValueError, x[:100], wp),
           "cols": (ValueError, torch.zeros(256, 64, dtype=torch.bfloat16),
                    wp),
           "dtype": (TypeError, x.float(), wp),
           "packing": (ValueError, x, wp.reshape(2, 16, 128, 8))}[case]
    with pytest.raises(bad[0]):
        stack.mma_chain(bad[1], bad[2])


@pytest.mark.parametrize("case", ["layer", "channels", "dtype", "small",
                                  "no_packed_weights"])
def test_mma_layer_rejects_bad_input(sp16, case):
    x = torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16)
    bad = {"layer": (ValueError, x, sp16, 1),
           "channels": (ValueError, x, sp16, 4),
           "dtype": (TypeError, x.float(), sp16, 2),
           "small": (ValueError, x[:, :2], sp16, 2),
           "no_packed_weights": (ValueError, x, tuple(sp16), 2)}[case]
    with pytest.raises(bad[0]):
        stack.mma_layer(bad[1], bad[2], bad[3])


def test_probe_rehearsal_on_cpu(capsys):
    assert mma_probe.main(["--device", "cpu", "--rows", "256", "--products",
                           "2", "--iters", "1"]) == 0
    assert "no device time" in capsys.readouterr().out


def test_mid_mma_changes_no_cpu_result(sp16, sp32, rng, monkeypatch):
    ylow = torch.from_numpy(rng.random((1, 7, 9), dtype=np.float32))
    uvp = torch.from_numpy(rng.random((1, 7, 9, 8), dtype=np.float32))
    outs = {}
    for flag in (True, False):
        monkeypatch.setattr(stack, "MID_MMA", flag)
        stack.reset_launches()
        y16 = ylow.to(torch.bfloat16)
        outs[flag] = (stack.stack_scale(y16, sp16),
                      stack.stack_scale(ylow, sp32),
                      stack.stack_noise(y16, sp16),
                      stack.stack_scale_fused_u8(y16, uvp, sp16),
                      stack.stack_scale_upto(y16, sp16, 4))
        assert stack.LAUNCHES == 0
        assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                      "mma_zs": 0, "mma_pp": 0,
                                      "mma_tf32": 0, "mma_resident": 0,
                                      "mma_split": 0, "mma_tile": 0}
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)


class _FakeLib:
    """Stands in for a ctypes library: records every C entry called with
    its arguments and reports success."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def _fake_launcher(calls, bf16: bool):
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = "scale", None, 0
    run.libs = {name: _FakeLib(calls)
                for name in ("stack", "mma", "l6", "l7", "l1", "mma_tf32")}
    run.bf16, run.stream = int(bf16), 0
    return run


@pytest.mark.parametrize("bf16,mid_mma,want", [
    (True, True, {"mma": 5, "ffma": 0, "mma_tf32": 0, "mma_resident": 4,
                  "mma_split": 1}),
    (True, False, {"mma": 0, "ffma": 5, "mma_tf32": 0, "mma_resident": 0,
                   "mma_split": 0}),
    (False, True, {"mma": 0, "ffma": 0, "mma_tf32": 5, "mma_resident": 0,
                   "mma_split": 0}),
    (False, False, {"mma": 0, "ffma": 5, "mma_tf32": 0, "mma_resident": 0,
                    "mma_split": 0})])
def test_launch_count_table(sp16, sp32, monkeypatch, bf16, mid_mma, want):
    """Which C entry each of a whole stack's 7 layers goes to, by storage
    dtype and MID_MMA, with the arguments the tensor-core entries get:
    layer 1 on csrc/l1.cu and layer 7 folded on csrc/l7.cu (bf16 on the
    tensor cores, f32 with FFMA) whatever MID_MMA says; layers 2-6 of an
    f32 stack as 3xTF32 while MID_MMA is on; a bf16 stack's layers 2-5 on
    the persistent kernel's resident route and layer 6 on its split route,
    none on the tile kernel."""
    monkeypatch.setattr(stack, "MID_MMA", mid_mma)
    stack.reset_launches()
    sp = sp16 if bf16 else sp32
    calls = []
    run = _fake_launcher(calls, bf16)
    x = torch.zeros(1, dtype=sp[0][0].dtype)
    n, ph, pw = 2, 10, 12
    for k in range(7):
        run.layer(k, False, x, sp, x, n, ph, pw)
    assert stack.LAUNCHES == stack.KERNEL_LAUNCHES["scale"] == 7
    assert stack.L6_LAUNCHES["direct"] == 1
    assert stack.MID_LAUNCHES == {**want, "chain": 0, "mma_zs": 0,
                                  "mma_pp": 0, "mma_tile": 0}
    assert stack.L1_LAUNCHES == {"l1": 1, "ffma": 0}
    assert [fn for fn, _ in calls] == [
        "w2x_l1" if k == 0
        else "w2x_mma_layer" if want["mma"] and 1 <= k <= 5
        else "w2x_tf32_layer" if want["mma_tf32"] and 1 <= k <= 5
        else "w2x_l7_fold" if k == 6 else "w2x_stack_layer"
        for k in range(7)]
    assert stack.L7_LAUNCHES == {"fold": int(bf16), "fold_f32": int(not bf16),
                                 "cell": 0, "pixel": 0}
    stack.reset_launches()
    assert stack.MID_LAUNCHES == {"mma": 0, "ffma": 0, "chain": 0,
                                  "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                  "mma_resident": 0, "mma_split": 0,
                                  "mma_tile": 0}
    if want["mma_tf32"]:
        for k, (_, args) in list(enumerate(calls))[1:6]:
            # (bf16, layer, x, whi, wlo, b, y, n, hin, win, smem, stream)
            assert args[:2] == (0, k)
            assert args[3:5] == tuple(t.data_ptr() for t in sp.wt[k - 1])
            assert args[5] == sp[k][1].data_ptr()
            assert args[7:] == (n, 2 * ph + 14 - 2 * k, 2 * pw + 14 - 2 * k,
                                stack.tf32_plan(*stack.WIDTHS[k]).smem_bytes,
                                0)
    if not want["mma"]:
        return
    for k, (_, args) in list(enumerate(calls))[1:6]:
        plan = stack.mma_plan(*stack.WIDTHS[k])
        # (bf16, ci, co, x, wp, b, y, n, hin, win, smem_bytes, stream): the
        # entry is keyed by the layer's widths
        assert args[:3] == (1, *stack.WIDTHS[k])
        assert args[4] == sp.wm[k - 1].data_ptr()
        assert args[5] == sp[k][1].data_ptr()
        assert args[7:] == (n, 2 * ph + 14 - 2 * k, 2 * pw + 14 - 2 * k,
                            plan.smem_bytes, 0)


class _FailingLib:
    """A ctypes library whose every entry reports a launch error."""

    def __getattr__(self, fn):
        if fn == "w2x_error_string":
            return lambda err: b"invalid argument"
        return lambda *args: 1


@pytest.mark.parametrize("k", MID)
def test_failed_launch_counts_nowhere(sp16, sp32, monkeypatch, k):
    """A launch counts after its error code is read: one that is refused
    raises and leaves every count as it was, for either mid-layer kernel."""
    x = torch.zeros(1, dtype=torch.bfloat16)
    for bf16, sp in ((True, sp16), (False, sp32)):
        monkeypatch.setattr(stack, "MID_MMA", True)
        stack.reset_launches()
        run = _fake_launcher([], bf16)
        run.libs = {name: _FailingLib()
                    for name in ("stack", "mma", "l6", "mma_tf32")}
        with pytest.raises(RuntimeError, match="invalid argument"):
            run.layer(k - 1, False, x, sp, x, 1, 10, 12)
        assert stack.LAUNCHES == 0 and not any(stack.L6_LAUNCHES.values())
        assert not any(stack.MID_LAUNCHES.values())


def test_mma_layer_alone_counts_as_no_stack_launch(sp16):
    """mma_layer's own launcher has no wrapper kind: its launch shows under
    MID_LAUNCHES["mma"] and in no count that whole stacks add to."""
    stack.reset_launches()
    calls = []
    run = _fake_launcher(calls, True)
    run.kind = None
    x = torch.zeros(1, dtype=torch.bfloat16)
    run.mma_layer(3, x, sp16, x, 1, 20, 24)
    assert [fn for fn, _ in calls] == ["w2x_mma_layer"]
    assert stack.MID_LAUNCHES == {"mma": 1, "ffma": 0, "chain": 0,
                                  "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                  "mma_resident": 1, "mma_split": 0,
                                  "mma_tile": 0}
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())
    assert not any(stack.L6_LAUNCHES.values())
    stack.reset_launches()


@pytest.mark.parametrize("k", MID)
def test_tile_kernel_dispatch(sp16, k):
    """persistent=False runs the same layer on the tile kernel: the variant
    entry at zs = pp = 0 with the tile plan's shared memory, counted under
    MID_LAUNCHES "mma" and "mma_tile"; the default runs w2x_mma_layer with
    the persistent plan's, counted under "mma" and its route."""
    calls = []
    run = _fake_launcher(calls, True)
    run.kind = None
    x = torch.zeros(1, dtype=torch.bfloat16)
    ci, co = stack.WIDTHS[k - 1]
    for persistent in (False, True):
        stack.reset_launches()
        run.mma_layer(k - 1, x, sp16, x, 2, 20, 24, persistent=persistent)
        route = stack.mma_plan(ci, co, persistent=persistent).route
        assert stack.MID_LAUNCHES == {
            **{key: 0 for key in stack.MID_LAUNCHES}, "mma": 1,
            f"mma_{route}": 1}
    (fn0, args0), (fn1, args1) = calls
    # (bf16, layer, zs, pp, x, wp, b, y, n, hin, win, smem, stream)
    assert fn0 == "w2x_mma_layer_variant" and args0[:4] == (1, k - 1, 0, 0)
    assert args0[8:] == (2, 20, 24, stack.mma_plan(
        ci, co, persistent=False).smem_bytes, 0)
    # (bf16, ci, co, x, wp, b, y, n, hin, win, smem, stream)
    assert fn1 == "w2x_mma_layer" and args1[:3] == (1, ci, co)
    assert args1[7:] == (2, 20, 24, stack.mma_plan(ci, co).smem_bytes, 0)
    assert args0[5] == args1[4] == sp16.wm[k - 2].data_ptr()
    stack.reset_launches()


def test_stack_span_records_the_routes(sp16, monkeypatch):
    """The w2x.stack span's mid_routes attribute names the routes a call's
    layers 2-6 took, from the change in MID_LAUNCHES; a call that launched
    nothing (a CPU tensor: the plain version) sets none."""
    from waifu2x_torch.utils import trace
    seen = {}

    class Span:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def set(self, **attrs):
            seen.update(attrs)

    monkeypatch.setattr(trace, "span", lambda *a, **k: Span())

    def five_layers(x, sp):
        stack.MID_LAUNCHES["mma_resident"] += 4
        stack.MID_LAUNCHES["mma_split"] += 1
        return x
    stack.reset_launches()
    y = torch.zeros(1, 4, 4, dtype=torch.bfloat16)
    stack._spanned("scale")(five_layers)(y, sp16)
    assert seen == {"launches": 0, "mid_routes": "mma_resident:4 mma_split:1"}
    seen.clear()
    stack.stack_scale(y, sp16)
    assert seen == {"launches": 0}
    stack.reset_launches()


def test_noise_stack_layer_planes_round_odd_sizes_up(sp16, monkeypatch):
    """The noise stack runs on the plane rounded up to even: the tensor-core
    entry gets that plane's layer sizes."""
    monkeypatch.setattr(stack, "MID_MMA", True)
    calls = []
    run = _fake_launcher(calls, True)
    x = torch.zeros(1, dtype=torch.bfloat16)
    run.layer(3, True, x, sp16, x, 1, 27, 38)
    # (bf16, ci, co, x, wp, b, y, n, hin, win, smem, stream)
    assert calls[0][1][7:10] == (1, 28 + 14 - 6, 38 + 14 - 6)
    stack.reset_launches()
