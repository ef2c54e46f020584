"""The port's stream runtime on the CPU (waifu2x_torch.stream) against its
own batch steps and against the JAX package's StreamConverter on the same
frames. The port's FastStacks take the kernel's plain PyTorch version on
the CPU (f32); the JAX side runs its Pallas kernel in interpret mode, f32,
tile (16, 16), as tests/test_stream.py builds it.

Bars: stream output equal to the batch step's on the same batches, bit for
bit; against the JAX stream |diff| <= 1 on < 0.2% of bytes, where the two
sides take their f32 sums in another order before the final u8 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waifu2x_tpu.pipeline as jpl
import waifu2x_tpu.stream as jstream
from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_torch import pipeline as pl
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.ops.s2d import d2s_host_cmajor
from waifu2x_torch.stream import (
    StreamConverter,
    _to_bgr_u8_batch,
    _to_yuv_batch,
    resolve_stream_mesh,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scale_np():
    return as_numpy(init_params(jax.random.PRNGKey(2), JFLAGSHIP))


@pytest.fixture(scope="module")
def noise_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), JFLAGSHIP))


@pytest.fixture(scope="module")
def fast(scale_np):
    return pl.FastStack.build(params_from_numpy(scale_np), True,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def fast_n(noise_np):
    return pl.FastStack.build(params_from_numpy(noise_np), False,
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jfast(scale_np):
    return jpl.FastStack.build(scale_np, scale_input=True, tile=(16, 16),
                               interpret=True, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jfast_n(noise_np):
    return jpl.FastStack.build(noise_np, scale_input=False, tile=(16, 16),
                               interpret=True, dtype=jnp.float32)


def _assert_u8_close(got, ref, frac=0.002):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < frac, (
        diff.max(), (diff != 0).mean())


def _assert_streams_close(outs, jouts):
    assert len(outs) == len(jouts)
    for got, ref in zip(outs, jouts):
        assert got.shape == ref.shape
    _assert_u8_close(np.concatenate([o.ravel() for o in outs]),
                     np.concatenate([np.asarray(o).ravel() for o in jouts]))


def _yuv(frames):
    return _to_yuv_batch(torch.from_numpy(np.stack(frames)))


def test_stream_matches_batch(fast, jfast, rng):
    frames = [rng.integers(0, 256, (20, 24, 3), np.uint8) for _ in range(7)]
    sc = StreamConverter(fast, batch=3, depth=2, device="cpu")
    outs = list(sc.process_frames(frames))
    assert len(outs) == 7
    ref = d2s_host_cmajor(
        pl.scale2x_batch_u8_fused(_yuv(frames), fast).numpy())
    for got, want in zip(outs, ref):
        assert got.shape == (40, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    jouts = list(jstream.StreamConverter(jfast, batch=3, depth=2)
                 .process_frames(frames))
    _assert_streams_close(outs, jouts)


@pytest.mark.parametrize("tail,ydense", [("xla", True), ("kernel", False)],
                         ids=["xla-ydense", "kernel"])
def test_stream_follows_the_tail_switches(fast, rng, monkeypatch, tail,
                                          ydense):
    """The stream's scale step is scale2x_batch_u8_fused under the
    module's FUSED_TAIL / YDENSE: equal to that step on the same batches."""
    frames = [rng.integers(0, 256, (12, 14, 3), np.uint8) for _ in range(5)]
    default = list(StreamConverter(fast, batch=2, device="cpu")
                   .process_frames(frames))
    monkeypatch.setattr(pl, "FUSED_TAIL", tail)
    monkeypatch.setattr(pl, "YDENSE", ydense)
    outs = list(StreamConverter(fast, batch=2, device="cpu")
                .process_frames(frames))
    for k in range(0, 4, 2):
        ref = d2s_host_cmajor(pl.scale2x_batch_u8_fused(
            _yuv(frames[k:k + 2]), fast).numpy())
        np.testing.assert_array_equal(outs[k], ref[0])
        np.testing.assert_array_equal(outs[k + 1], ref[1])
    if ydense:
        for a, b in zip(outs, default):
            np.testing.assert_array_equal(a, b)
    else:
        _assert_u8_close(np.stack(outs), np.stack(default), frac=0.005)


def test_stream_noise_scale_mode(fast, fast_n, jfast, jfast_n, rng):
    """noise_scale streaming == the chained batch steps on the same
    batches."""
    frames = [rng.integers(0, 256, (20, 24, 3), np.uint8) for _ in range(5)]
    sc = StreamConverter(fast, batch=2, depth=1, fast_noise=fast_n,
                         mode="noise_scale", device="cpu")
    outs = list(sc.process_frames(frames))
    assert len(outs) == 5
    for pair0 in range(0, 4, 2):
        yuv = _yuv(frames[pair0:pair0 + 2])
        ref = d2s_host_cmajor(pl.scale2x_batch_u8_fused(
            pl.noise_batch_fast(yuv, fast_n), fast).numpy())
        np.testing.assert_array_equal(outs[pair0], ref[0])
        np.testing.assert_array_equal(outs[pair0 + 1], ref[1])
    jouts = list(jstream.StreamConverter(
        jfast, batch=2, depth=1, fast_noise=jfast_n, mode="noise_scale")
        .process_frames(frames))
    _assert_streams_close(outs, jouts)


def test_stream_noise_mode_even_and_odd(fast_n, jfast_n, noise_np, rng):
    """Pure-denoise streaming emits raster BGR at input size: even frames
    through the u8 cmajor tail, odd ones through the raster branch; both
    within one level of the f32 non-kernel noise step."""
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.srcnn import SRCNN
    sc = StreamConverter(None, batch=2, fast_noise=fast_n, mode="noise",
                         device="cpu")
    jsc = jstream.StreamConverter(None, batch=2, fast_noise=jfast_n,
                                  mode="noise")
    model = SRCNN.from_params(params_from_numpy(noise_np))
    for h, w in ((24, 32), (21, 27)):
        frames = [rng.integers(0, 256, (h, w, 3), np.uint8)
                  for _ in range(3)]
        outs = list(sc.process_frames(frames))
        assert [o.shape for o in outs] == [(h, w, 3)] * 3
        assert all(o.dtype == np.uint8 for o in outs)
        ref = _to_bgr_u8_batch(pl.noise_batch(
            _yuv(frames), model, Config(mode="noise", block_size=0))).numpy()
        diff = np.abs(np.stack(outs).astype(int) - ref.astype(int))
        assert diff.max() <= 1
        _assert_streams_close(outs, list(jsc.process_frames(frames)))


def test_stream_mixed_sizes_ordered(fast, jfast, rng):
    """Mixed-geometry streams group by shape, pad tail batches by repeating
    the last frame, and still yield outputs in input order."""
    shapes = [(16, 16), (20, 24), (16, 16), (16, 16), (20, 24), (16, 16),
              (12, 18)]
    frames = [rng.integers(0, 256, (*s, 3), np.uint8) for s in shapes]
    sc = StreamConverter(fast, batch=2, depth=1, device="cpu")
    outs = list(sc.process_frames(frames))
    assert len(outs) == len(frames)
    for frame, out in zip(frames, outs):
        assert out.shape == (2 * frame.shape[0], 2 * frame.shape[1], 3)
        ref = d2s_host_cmajor(pl.scale2x_batch_u8_fused(
            _yuv([frame, frame]), fast).numpy())[0]
        np.testing.assert_array_equal(out, ref)
    jouts = list(jstream.StreamConverter(jfast, batch=2, depth=1)
                 .process_frames(frames))
    _assert_streams_close(outs, jouts)


def test_stream_tail_batches_are_padded(fast, rng, monkeypatch):
    """Every dispatch of a shape has the shape's batch size: a short tail
    batch repeats its last frame."""
    sizes = []
    orig = pl.scale2x_batch_u8_fused
    import waifu2x_torch.stream as tstream

    def counting(yuv, fast, **kw):
        sizes.append(tuple(yuv.shape))
        return orig(yuv, fast, **kw)

    monkeypatch.setattr(tstream, "scale2x_batch_u8_fused", counting)
    frames = [rng.integers(0, 256, (8, 10, 3), np.uint8) for _ in range(5)]
    outs = list(StreamConverter(fast, batch=3, depth=1, device="cpu")
                .process_frames(frames))
    assert len(outs) == 5 and sizes == [(3, 8, 10, 3)] * 2
    assert list(StreamConverter(fast, device="cpu").process_frames([])) == []


def test_stream_mode_validation(fast):
    with pytest.raises(ValueError):
        StreamConverter(fast, mode="bogus", device="cpu")
    with pytest.raises(ValueError):
        StreamConverter(fast, mode="noise_scale", device="cpu")
    with pytest.raises(ValueError):
        StreamConverter(None, mode="scale", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device"):
        StreamConverter(fast, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="scale_params"):
        StreamConverter.from_params(mode="scale", device="cpu")
    with pytest.raises(ValueError, match="noise_params"):
        StreamConverter.from_params(scale_params=[], mode="noise_scale",
                                    device="cpu")


def test_stream_defaults_to_the_card(fast):
    """With no device argument the stream runs on the CUDA card, and
    raises where there is none; it never carries on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamConverter(fast)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamConverter.from_params(scale_params=[], mode="scale")


def test_from_params_noise_dtype_policy(scale_np):
    """from_params applies the JAX package's noise-precision policy: an f32
    noise stack under noise_scale, bf16 under the throughput opt-out and
    for the single-stack noise mode."""
    params = params_from_numpy(scale_np)
    jkw = dict(scale_params=scale_np, noise_params=scale_np, interpret=True)
    kw = dict(scale_params=params, noise_params=params, device="cpu")
    to_torch = {jnp.dtype(jnp.float32): torch.float32,
                jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for extra in (dict(mode="noise_scale"),
                  dict(mode="noise_scale", quality_noise=False)):
        sc = StreamConverter.from_params(**kw, **extra)
        jsc = jstream.StreamConverter.from_params(**jkw, **extra)
        assert sc.fast_noise.dtype == to_torch[jnp.dtype(jsc.fast_noise.dtype)]
        assert sc.fast.dtype == to_torch[jnp.dtype(jsc.fast.dtype)]
        assert sc.mode == "noise_scale" and sc.device.type == "cpu"
    sc = StreamConverter.from_params(**kw, mode="noise_scale")
    assert sc.fast_noise.dtype == torch.float32
    assert sc.fast.dtype == torch.bfloat16
    sc_n = StreamConverter.from_params(noise_params=params, mode="noise",
                                       device="cpu", batch=5, depth=3)
    assert sc_n.fast is None and sc_n.fast_noise.dtype == torch.bfloat16
    assert (sc_n.batch, sc_n.depth) == (5, 3)


@pytest.mark.parametrize("mode", ["scale", "noise", "noise_scale"])
def test_shape_batch_matches_jax(fast, fast_n, jfast, jfast_n, mode):
    shapes = [(16, 16), (256, 256), (512, 512), (720, 1280), (1080, 1920),
              (1081, 1919), (2160, 3840), (4320, 7680), (1, 1)]
    for batch in (1, 2, 8, 16, 256):
        sc = StreamConverter(fast, batch=batch, fast_noise=fast_n, mode=mode,
                             device="cpu")
        jsc = jstream.StreamConverter(jfast, batch=batch,
                                      fast_noise=jfast_n, mode=mode)
        for h, w in shapes:
            assert sc._shape_batch(h, w) == jsc._shape_batch(h, w), (
                mode, batch, h, w)
    assert StreamConverter(fast, batch=8, fast_noise=fast_n,
                           mode="noise_scale",
                           device="cpu")._shape_batch(1080, 1920) == 4


@pytest.mark.parametrize("spec", ["off", "auto", (1, 1, 1)])
def test_resolve_stream_mesh_single_device(spec):
    assert resolve_stream_mesh(spec) is None


@pytest.mark.parametrize("spec", [(2, 1, 1), (1, 2, 4)])
def test_resolve_stream_mesh_rejects_larger_shapes(spec):
    with pytest.raises(NotImplementedError, match="A item 14"):
        resolve_stream_mesh(spec)
