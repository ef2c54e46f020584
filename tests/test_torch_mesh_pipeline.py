"""The port's composed chain on a ("dp", "dy", "sp") mesh
(waifu2x_torch/parallel/mesh_pipeline.py) and its callers (Converter,
StreamConverter, the CLI) on 8 positions of the CPU device, against the
port's own single-device kernel path, and at small shapes against the JAX
package's MeshPipeline (interpret-mode f32 kernels), on seeded numpy
inputs.

Bars: against the port's single device, bit for bit: the f32 planes and the
u8 outputs (every stage runs the same plain stack per pixel, and the u8
tails take the same f32 steps). Against JAX, the u8 tie bar of
tests/test_torch_pipeline.py (|diff| <= 1 at < 0.2% of bytes)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
import waifu2x_tpu.stream as jstream
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.models.weights import save_model_json
from waifu2x_tpu.parallel import mesh_pipeline as jmp
from waifu2x_torch import cli as tcli
from waifu2x_torch import io as tio
from waifu2x_torch import pipeline as pl
from waifu2x_torch.config import Config
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops.resize import LINEAR, resize
from waifu2x_torch.ops.s2d import d2s_host_cmajor
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.parallel.mesh_pipeline import (
    MeshPipeline,
    auto_spatial_shape,
    make_mesh3,
)
from waifu2x_torch.stream import StreamConverter, resolve_stream_mesh

torch.set_num_threads(2)

SHAPES = [(1, 1, 8), (1, 2, 4), (2, 2, 2), (1, 4, 2)]


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(m, "CPU_DEVICES", 8)


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(7), JFLAGSHIP))


@pytest.fixture(scope="module")
def params(params_np):
    return params_from_numpy(params_np)


@pytest.fixture(scope="module")
def fasts(params):
    return (pl.FastStack.build(params, True, dtype=torch.float32,
                               device="cpu"),
            pl.FastStack.build(params, False, dtype=torch.float32,
                               device="cpu"))


def _mesh(shape):
    return make_mesh3(shape, m.local_devices("cpu")[:np.prod(shape)])


def _u8(rng, n, h, w):
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _yuv(u8):
    return pl._to_yuv(torch.from_numpy(u8))


def _host(out_u8_cmajor):
    return d2s_host_cmajor(out_u8_cmajor.numpy())


def _raster_u8(yuv):
    return pl._to_bgr_u8(yuv).numpy()


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


# --- the chain: __graft_entry__._dryrun_chain's three checks -----------------

@pytest.mark.parametrize("shape", SHAPES)
def test_noise_scale_chain(fasts, rng, shape):
    """noise_scale with the `y=` handoff: the denoised plane, the f32 chain
    and the u8 output equal the single device's, on dp + 1 frames of an odd
    size (frame padding and _fix_pad)."""
    fast_s, fast_n = fasts
    dp, dy, sp = shape
    h, w = 8 * dy + 7, 8 * sp + 1
    u8 = _u8(rng, dp + 1, h, w)
    yuv = _yuv(u8)
    pipe = MeshPipeline(_mesh(shape), fast_scale=fast_s, fast_noise=fast_n,
                        mode="noise_scale", scale_ratio=2.0)
    y_ref = pl.noise_y_batch_fast(yuv[..., 0], fast_n, out_dtype=None)
    y_mesh = m.gather(pipe._noise_y(pipe.shard(yuv)))
    torch.testing.assert_close(y_mesh[:dp + 1, :h, :w], y_ref, rtol=0,
                               atol=0)
    ref = _host(pl.scale2x_batch_u8_fused(yuv, fast_s, y=y_ref))
    np.testing.assert_array_equal(pipe.convert_bgr_u8(u8), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_ratio4_two_iterations(fasts, rng, shape):
    fast_s, _ = fasts
    dp, dy, sp = shape
    u8 = _u8(rng, dp + 1, 8 * dy + 7, 8 * sp + 1)
    yuv = _yuv(u8)
    pipe = MeshPipeline(_mesh(shape), fast_scale=fast_s, mode="scale",
                        scale_ratio=4.0)
    mid = pl.scale2x_batch_fast(yuv, fast_s)
    ref = _host(pl.scale2x_batch_u8_fused(mid, fast_s))
    np.testing.assert_array_equal(pipe.convert_bgr_u8(u8), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_ratio3_linear_shrink(fasts, rng, shape):
    """Two iterations and the LINEAR shrink 0.75 (main.cpp:107-114,
    158-167): the raster finish, one "dp" row at a time."""
    fast_s, _ = fasts
    dp, dy, sp = shape
    u8 = _u8(rng, dp + 1, 8 * dy + 7, 8 * sp + 1)
    yuv = _yuv(u8)
    pipe = MeshPipeline(_mesh(shape), fast_scale=fast_s, mode="scale",
                        scale_ratio=3.0)
    assert (pipe.iters, pipe.shrink) == (2, 0.75)
    full = pl.scale2x_batch_fast(pl.scale2x_batch_fast(yuv, fast_s), fast_s)
    dsize = (int(full.shape[1] * 0.75), int(full.shape[2] * 0.75))
    ref = _raster_u8(resize(full, dsize, LINEAR, h_axis=1))
    np.testing.assert_array_equal(pipe.convert_bgr_u8(u8), ref)


@pytest.mark.parametrize("shape", [(1, 2, 4), (2, 2, 2)])
def test_f32_chain_bit_equal(fasts, rng, shape):
    """The f32 stages one by one: the denoised plane, the first iteration
    with the override and the second, each equal to the single device's."""
    fast_s, fast_n = fasts
    pipe = MeshPipeline(_mesh(shape), fast_scale=fast_s, fast_noise=fast_n,
                        mode="noise_scale", scale_ratio=4.0)
    yuv = torch.from_numpy(rng.random((2, 24, 32, 3), dtype=np.float32))
    cur = pipe.shard(yuv)
    y = pipe._noise_y(cur)
    ref_y = pl.noise_y_batch_fast(yuv[..., 0], fast_n, out_dtype=None)
    torch.testing.assert_close(m.gather(y), ref_y, rtol=0, atol=0)
    mid = pipe._scale_mid(cur, y)
    ref_mid = pl.scale2x_batch_fast(pl._with_y(yuv, ref_y), fast_s)
    torch.testing.assert_close(m.gather(mid), ref_mid, rtol=0, atol=0)
    last = pipe._scale_mid(mid)
    torch.testing.assert_close(m.gather(last),
                               pl.scale2x_batch_fast(ref_mid, fast_s),
                               rtol=0, atol=0)


# --- the other routes --------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 4), (2, 1, 4)])
def test_noise_only(fasts, rng, shape):
    _, fast_n = fasts
    pipe = MeshPipeline(_mesh(shape), fast_noise=fast_n, mode="noise")
    u8 = _u8(rng, 2, 32, 48)
    ref = _host(pl.noise_batch_u8_fused(_yuv(u8), fast_n))
    np.testing.assert_array_equal(pipe.convert_bgr_u8(u8), ref)


@pytest.mark.parametrize("mode,ratio", [("noise", 2.0), ("scale", 4.0),
                                        ("noise_scale", 4.0)])
def test_odd_sizes_fix_pad(fasts, rng, mode, ratio):
    """Odd sizes ride the mesh padding, and _fix_pad re-replicates it from
    the true edge between chained stages: without it the last rows and
    columns drift. Held against the single device on the unpadded image."""
    fast_s, fast_n = fasts
    pipe = MeshPipeline(_mesh((1, 2, 4)), fast_scale=fast_s,
                        fast_noise=fast_n, mode=mode, scale_ratio=ratio)
    u8 = _u8(rng, 1, 31, 45)
    yuv = _yuv(u8)
    if mode == "noise":
        ref = _raster_u8(pl.noise_batch_fast(yuv, fast_n))
    else:
        if mode == "noise_scale":
            yuv = pl._with_y(yuv, pl.noise_y_batch_fast(yuv[..., 0], fast_n))
        ref = _host(pl.scale2x_batch_u8_fused(
            pl.scale2x_batch_fast(yuv, fast_s), fast_s))
    got = pipe.convert_bgr_u8(u8)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_fix_pad_spans_shards(fasts, rng):
    """Padding wider than a shard: on sp = 8 a 33-column image pads to 48,
    6 columns a shard, so shards 6 and 7 hold padding only and take the
    true edge column from shard 5."""
    fast_s, _ = fasts
    pipe = MeshPipeline(_mesh((1, 1, 8)), fast_scale=fast_s, mode="scale")
    x = torch.from_numpy(rng.random((1, 4, 48, 3), dtype=np.float32))
    fixed = m.gather(pipe._fix_pad(m.shard(x, pipe.mesh, ("dp", "dy", "sp",
                                                          None)), (3, 33)))
    want = x.clone()
    want[:, :, 33:] = want[:, :, 32:33]
    want[:, 3:] = want[:, 2:3]
    torch.testing.assert_close(fixed, want, rtol=0, atol=0)


@pytest.mark.parametrize("ratio,iters,shrink", [(1.0, 0, 0.0),
                                                (0.6, 0, 0.6)])
def test_identity_and_pure_shrink_ratios(fasts, rng, ratio, iters, shrink):
    fast_s, _ = fasts
    pipe = MeshPipeline(_mesh((1, 2, 4)), fast_scale=fast_s, mode="scale",
                        scale_ratio=ratio)
    assert (pipe.iters, pipe.shrink) == (iters, shrink)
    u8 = _u8(rng, 1, 24, 32)
    yuv = _yuv(u8)
    out = yuv if shrink == 0.0 else resize(
        yuv, (int(24 * shrink), int(32 * shrink)), LINEAR, h_axis=1)
    np.testing.assert_array_equal(pipe.convert_bgr_u8(u8), _raster_u8(out))


def test_narrow_shard_raises(fasts, rng):
    _, fast_n = fasts
    pipe = MeshPipeline(_mesh((1, 1, 8)), fast_noise=fast_n, mode="noise")
    with pytest.raises(ValueError, match="halo"):
        pipe.convert_bgr_u8(_u8(rng, 1, 16, 32))   # 4-col shards < 8
    assert pipe.min_image_hw() == (8, 64)
    with pytest.raises(ValueError, match="fast_scale"):
        MeshPipeline(_mesh((1, 1, 8)), mode="scale")


def test_volume_warning_once(fasts, rng, caplog, monkeypatch):
    import waifu2x_torch.parallel.mesh_pipeline as mp
    logger = mp.log
    logger.addHandler(caplog.handler)
    try:
        monkeypatch.setattr(mp, "BAND_PX", 100)
        pipe = MeshPipeline(_mesh((1, 1, 2)), fast_scale=fasts[0])
        for _ in range(2):
            pipe.shard(_u8(rng, 1, 16, 32))
    finally:
        logger.removeHandler(caplog.handler)
    recs = [r for r in caplog.records if "per device" in r.getMessage()]
    assert len(recs) == 1


# --- against the JAX package -------------------------------------------------

def test_mesh_pipeline_matches_jax(params_np, fasts, rng):
    """noise_scale on (2, 1, 2): both stacks, a halo on "sp", frames on
    "dp", the port's chain against JAX's."""
    fast_s, fast_n = fasts
    jfs = jpl.FastStack.build(params_np, scale_input=True, tile=(8, 16),
                              interpret=True, dtype=jnp.float32)
    jfn = jpl.FastStack.build(params_np, scale_input=False, tile=(8, 16),
                              interpret=True, dtype=jnp.float32)
    u8 = _u8(rng, 2, 16, 16)
    jpipe = jmp.MeshPipeline(jmp.make_mesh3((2, 1, 2), jax.devices()[:4]),
                             fast_scale=jfs, fast_noise=jfn,
                             mode="noise_scale")
    pipe = MeshPipeline(_mesh((2, 1, 2)), fast_scale=fast_s,
                        fast_noise=fast_n, mode="noise_scale")
    _assert_u8_close(pipe.convert_bgr_u8(u8), jpipe.convert_bgr_u8(u8))
    assert pipe.min_image_hw() == jpipe.min_image_hw()
    # the stream's per-shape cap on a mesh is JAX's rule
    for mode in ("scale", "noise", "noise_scale"):
        for batch in (1, 2, 16):
            sc = StreamConverter(fast_s, batch=batch, fast_noise=fast_n,
                                 mode=mode, device="cpu", mesh=pipe.mesh)
            jsc = jstream.StreamConverter(jfs, batch=batch, fast_noise=jfn,
                                          mode=mode, mesh=jpipe.mesh)
            for h, w in [(16, 16), (512, 512), (1080, 1920), (2160, 3840),
                         (4320, 7680)]:
                assert sc._shape_batch(h, w) == jsc._shape_batch(h, w)


@pytest.mark.parametrize("n,h,w", [(8, 1080, 3840), (8, 256, 4096),
                                   (8, 128, 4096), (8, 4096, 128),
                                   (8, 100, 100), (6, 4096, 4096),
                                   (4, 720, 1280), (2, 130, 300)])
def test_auto_spatial_shape_matches_jax(n, h, w):
    assert auto_spatial_shape(n, h, w) == jmp.auto_spatial_shape(n, h, w)


@pytest.mark.parametrize("spec", ["off", "auto", (1, 1, 1), (2, 1, 4),
                                  (1, 2, 4), (4, 2, 4)])
def test_resolve_stream_mesh_matches_jax(spec):
    got = resolve_stream_mesh(spec, "cpu")
    want = jstream.resolve_stream_mesh(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == want.devices.shape


# --- the callers -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["scale", "noise", "noise_scale"])
def test_converter_mesh_matches_single_device(params, rng, mode):
    np_ = params if mode != "scale" else None
    sp_ = params if mode != "noise" else None
    base = dict(mode=mode, use_pallas=True, compute_dtype="float32")
    ref_conv = pl.Converter.from_params(Config(mesh="off", **base), np_, sp_,
                                        device="cpu")
    conv = pl.Converter.from_params(Config(mesh="2x2x2", **base), np_, sp_,
                                    device="cpu")
    img = _u8(rng, 1, 48, 64)[0]
    assert conv._mesh_pipe(48, 64) is not None
    np.testing.assert_array_equal(conv.process_bgr_u8(img),
                                  ref_conv.process_bgr_u8(img))
    tiny = _u8(rng, 1, 12, 12)[0]   # under min_image_hw: one device
    assert conv._mesh_pipe(12, 12) is None
    np.testing.assert_array_equal(conv.process_bgr_u8(tiny),
                                  ref_conv.process_bgr_u8(tiny))


def test_converter_mesh_shrink_ratio(params, rng):
    base = dict(mode="scale", scale_ratio=3.0, use_pallas=True,
                compute_dtype="float32")
    img = _u8(rng, 1, 32, 48)[0]
    ref = pl.Converter.from_params(Config(mesh="off", **base), None, params,
                                   device="cpu").process_bgr_u8(img)
    got = pl.Converter.from_params(Config(mesh="1x2x4", **base), None,
                                   params, device="cpu").process_bgr_u8(img)
    assert got.shape == ref.shape == (96, 144, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["scale", "noise", "noise_scale"])
def test_stream_mesh_matches_single_device(fasts, rng, mode):
    """Mixed sizes, odd ones included (the mesh pads them), every frame in
    input order, equal to the single-device stream."""
    fast_s, fast_n = fasts
    frames = [_u8(rng, 1, h, w)[0]
              for h, w in [(32, 40), (32, 40), (24, 48), (31, 41),
                           (32, 40), (24, 48)]]
    kw = dict(fast=fast_s if mode != "noise" else None,
              fast_noise=fast_n if mode != "scale" else None,
              mode=mode, batch=2, depth=1, device="cpu")
    ref = list(StreamConverter(**kw).process_frames(frames))
    got = list(StreamConverter(mesh=_mesh((2, 1, 4)), **kw)
               .process_frames(frames))
    assert len(got) == len(ref) == len(frames)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_cli_mesh_on_cpu_positions(params_np, rng, tmp_path):
    """--device cpu --mesh 2x2: four CPU positions for the run; the files
    equal the one-device run's."""
    mdir = tmp_path / "models"
    mdir.mkdir()
    save_model_json(str(mdir / "noise1_model.json"), params_np)
    save_model_json(str(mdir / "scale2.0x_model.json"), params_np)
    img = _u8(rng, 1, 40, 48)[0]
    outs = {}
    for mesh in ("off", "2x2"):
        d = tmp_path / mesh
        d.mkdir()
        src = str(d / "in.png")
        tio.imwrite_bgr(src, img)
        assert tcli.main(["-i", src, "--model_dir", str(mdir), "--device",
                          "cpu", "--pallas", "on", "--compute_dtype",
                          "float32", "--mesh", mesh]) == 0
        outs[mesh] = tio.imread_bgr(os.path.join(
            d, "in(noise_scale)(Level1)(x2.000000).png"))
    assert m.CPU_DEVICES == 8   # restored after the run
    assert outs["2x2"].shape == (80, 96, 3)
    np.testing.assert_array_equal(outs["2x2"], outs["off"])
