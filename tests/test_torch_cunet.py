"""waifu2x UpCUNet on the port (models/cunet.py, ops/unet.py,
pipeline.upcunet2x_batch_u8, Converter, StreamConverter, the CLI) against
the benchmark's plain reference (benchmark/reference/upcunet.py, f32, TF32
off, imports nothing of the port) on seeded weights, at a small tile: 76
input pixels a side (80 output pixels), frames of 2 x 3 tiles.

Bars: the f32 model within 3e-5 of the reference's f32 values (the repo's
f32 bar: the two sum the same products in another order); the bf16 model
at the configuration's own limits (configs/upcunet2x.json `fidelity_db`
for every frame, and the cell's `row_psnr_min_db` for every pair of output
rows), which the fp8 control and the planted faults miss. The CUDA kernels
are held against their plain versions on the card: the 3x3 layers' by
tools/cunet_probe.py and chip_smoke.py phase 34, the library layers'
epilogue (csrc/epi.cu) by chip_smoke.py phase 35."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from waifu2x_torch import pipeline as pl
from waifu2x_torch.config import Config
from waifu2x_torch.models import cunet
from waifu2x_torch.ops import stack, unet
from waifu2x_torch.ops.s2d import pack_mma
from waifu2x_torch.stream import StreamConverter

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TILE = 76
H, W = 80, 120            # 2 x 3 tiles at the 40-pixel step
CFG = json.loads((ROOT / "benchmark" / "configs" / "upcunet2x.json")
                 .read_text())
CELL = json.loads((ROOT / "benchmark" / "workloads" /
                   "upcunet2x.b4_1080.json").read_text())
SEED = CFG["stacks"][0]["seed"]


def _load(path):
    spec = importlib.util.spec_from_file_location(
        "cunet_reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(ROOT / "benchmark" / "reference" / "upcunet.py")


def image_like(seed, n, h, w):
    """The benchmark's frames: a bilinear field of one value per 32 pixels
    plus noise of 6 levels, u8 BGR."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((n, 3, h // 32 + 1, w // 32 + 1), generator=g)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    noise = torch.randn((n, h, w, 3), generator=g)
    return torch.clamp(torch.round(smooth * 255 + 6 * noise), 0,
                       255).to(torch.uint8)


def psnr(a, b) -> float:
    mse = ((a.float() - b.float()) ** 2).mean().item()
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-10))


def numbers(got, ref):
    """(least frame PSNR, least PSNR of a pair of output rows)."""
    d = (got.float() - ref.float()) ** 2
    frames = min(10 * math.log10(255.0 ** 2 / max(m, 1e-10))
                 for m in d.reshape(d.shape[0], -1).mean(1).tolist())
    rows = d.mean(dim=(2, 3)).reshape(d.shape[0], -1, 2).mean(2)
    return frames, 10 * math.log10(255.0 ** 2 / max(rows.max().item(),
                                                    1e-10))


def passes(got, ref) -> bool:
    f, r = numbers(got, ref)
    return f >= CFG["fidelity_db"] and r >= CELL["limits"]["row_psnr_min_db"]


@pytest.fixture(scope="module")
def params():
    return cunet.init_params(SEED)


@pytest.fixture(scope="module")
def frames():
    return image_like(7, 2, H, W)


@pytest.fixture(scope="module")
def ref_u8(params, frames):
    return REF.convert(frames, params, TILE)


@pytest.fixture(scope="module")
def m16(params):
    return unet.CunetModel.build(params, torch.bfloat16, "cpu", TILE)


@pytest.fixture(scope="module")
def m32(params):
    return unet.CunetModel.build(params, torch.float32, "cpu", TILE)


# -- the model ------------------------------------------------------------

def test_the_initialiser_is_the_references(params):
    ref = REF.init_params(SEED)
    assert list(ref) == list(params) == list(cunet.param_shapes())
    assert all(torch.equal(ref[k], params[k]) for k in params)
    other = cunet.init_params(SEED + 1)
    assert not torch.equal(other["unet2.conv5.weight"],
                           params["unet2.conv5.weight"])


def test_state_dict_names_and_shapes():
    shapes = cunet.param_shapes()
    assert len(shapes) == 2 * 30
    assert shapes["unet1.conv1.conv.0.weight"] == (32, 3, 3, 3)
    assert shapes["unet1.conv2.seblock.conv1.weight"] == (8, 64, 1, 1)
    assert shapes["unet1.conv2_up.weight"] == (64, 64, 2, 2)
    assert shapes["unet1.conv_bottom.weight"] == (64, 3, 4, 4)
    assert shapes["unet2.conv3.conv.0.weight"] == (256, 128, 3, 3)
    assert shapes["unet2.conv3.seblock.conv2.bias"] == (128,)
    assert shapes["unet2.conv_bottom.weight"] == (3, 64, 3, 3)
    assert sum(k.kind in ("se1", "se2") for k in cunet.LAYERS) == 8
    assert len(cunet.LAYERS) - 8 == 22    # convolutions, SE left out


def test_a_436_tile(params):
    """800 output pixels a side; 1.298e11 multiply-adds, 202,788 an output
    pixel; UNet2's odd planes 207, 414 and 836 pixels."""
    assert cunet.out_side(436) == 800
    assert cunet.tile_macs(436) == 129_784_309_504
    sides = cunet.layer_sides(436)
    assert sides["unet2.conv3.conv.0"][0] == 207
    assert sides["unet2.conv2.conv.2"][1] == 414
    assert sides["unet2.conv1.conv.2"][1] == 836
    assert sides["unet1.conv_bottom"][1] == 840
    macs = cunet.layer_macs(436)
    mma = sum(v for k, v in macs.items() if cunet.BY_KEY[k].kind == "conv3"
              and stack.has_mma(cunet.BY_KEY[k].cin, cunet.BY_KEY[k].cout))
    assert 0.69 < mma / cunet.tile_macs(436) < 0.70


@pytest.mark.parametrize("size", [75, 72, 436 + 1])
def test_tiles_refused(size):
    with pytest.raises(ValueError):
        cunet.check_tile(size)


def test_weights_file_round_trip(params, tmp_path):
    path = tmp_path / "cunet.pt"
    cunet.save_params(path, params)
    back = cunet.load_params(path)
    assert all(torch.equal(back[k], params[k]) for k in params)
    torch.save({"state_dict": params}, tmp_path / "ckpt.pth")
    assert set(cunet.load_params(tmp_path / "ckpt.pth")) == set(params)
    bad = dict(params)
    bad["unet2.conv5.weight"] = bad["unet2.conv5.weight"][:, :32]
    with pytest.raises(ValueError, match="shape"):
        cunet.validate_params(bad)
    with pytest.raises(ValueError, match="missing"):
        cunet.validate_params({k: v for k, v in params.items()
                               if "unet2.conv5" not in k})


def test_the_initialiser_keeps_frames_image_like():
    """On the cell's kind of frames the reference's output neither clamps
    (under 10% of values at 0 or 255) nor flattens (a spread, the standard
    deviation of the u8 values, of 20 levels or more)."""
    for seed in (SEED, 1, 2):
        x = image_like(seed + 7, 2, 120, 160)
        out = REF.convert(x, cunet.init_params(seed), TILE)
        share = ((out == 0) | (out == 255)).float().mean().item()
        assert share < 0.10, (seed, share)
        assert out.float().std().item() >= 20.0, seed


# -- the tiling -----------------------------------------------------------

def test_tiles_cover_the_padded_frame():
    x = torch.rand(2, H, W, 3)
    tiles, ny, nx = pl.cunet_tiles(x, TILE)
    assert (ny, nx) == (2, 3) and tiles.shape == (12, TILE, TILE, 3)
    xp = F.pad(x.permute(0, 3, 1, 2), (18, 18, 18, 18), mode="replicate")
    t = tiles.reshape(2, 2, 3, TILE, TILE, 3)
    torch.testing.assert_close(t[1, 1, 2], xp[1, :, 40:116, 80:156]
                               .permute(1, 2, 0), rtol=0, atol=0)
    # ragged frames: the far sides replicate on to the step
    tiles, ny, nx = pl.cunet_tiles(torch.rand(1, 41, 39, 3), TILE)
    assert (ny, nx) == (2, 1)


def test_stitch_inverts_the_tile_order():
    out = torch.arange(2 * 2 * 3 * 4 * 4 * 3).reshape(12, 4, 4, 3)
    frames = pl.cunet_stitch(out, 2, 2, 3, 7, 11)
    assert frames.shape == (2, 7, 11, 3)
    # frame 1, tile (1, 2), its pixel (0, 1), RGB reversed
    assert torch.equal(frames[1, 4, 9], out[6 + 5, 0, 1].flip(-1))


# -- against the reference ------------------------------------------------

def test_f32_model_matches_the_reference(m32, params, frames):
    x = pl.unit_rgb(frames)
    tiles, ny, nx = pl.cunet_tiles(x, TILE)
    got = unet.upcunet_tiles(tiles, m32)
    o = got.shape[1]
    got = (got.reshape(2, ny, nx, o, o, 3).permute(0, 1, 3, 2, 4, 5)
           .reshape(2, ny * o, nx * o, 3)[:, :2 * H, :2 * W])
    ref = REF.upscale(x, params, TILE)
    assert got.shape == ref.shape == (2, 2 * H, 2 * W, 3)
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-5)


def test_f32_u8_step_matches_the_reference(m32, frames, ref_u8):
    got = pl.upcunet2x_batch_u8(pl.unit_rgb(frames), m32)
    assert got.dtype == torch.uint8 and got.shape == ref_u8.shape
    d = (got.int() - ref_u8.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3


def test_bf16_step_at_the_configurations_bar(m16, frames, ref_u8):
    got = pl.upcunet2x_batch_u8(pl.unit_rgb(frames), m16)
    assert passes(got, ref_u8), numbers(got, ref_u8)
    assert psnr(got, ref_u8) < 80.0      # bf16, not the f32 model


def test_the_fp8_control_misses_the_bar(params, frames, ref_u8):
    control = REF.convert(frames, params, TILE, "fp8")
    assert not passes(control, ref_u8)
    assert numbers(control, ref_u8)[0] < CFG["fidelity_db"]


def _se_over_the_frame(x, model, key):
    """The planted fault: the SE means over every tile of the batch (the
    whole frame) in place of each tile's own."""
    w1, b1, w2, b2 = model.se[key]
    z = torch.mean(x, dim=(0, 1, 2), dtype=torch.float32)
    z = torch.sigmoid(torch.relu(z @ w1 + b1) @ w2 + b2)
    return torch.mul(x, z.expand(x.shape[0], -1)[:, None, None, :],
                     out=torch.empty_like(x))


def _tiles_without_halo(x, tile):
    """The planted fault: each 40-pixel block padded by its own edge in
    place of its neighbours' pixels."""
    n, h, w, c = x.shape
    step = tile - 2 * pl.CUNET_HALO
    ny, nx = -(-h // step), -(-w // step)
    xp = F.pad(x.permute(0, 3, 1, 2), (0, nx * step - w, 0, ny * step - h),
               mode="replicate")
    blocks = xp.unfold(2, step, step).unfold(3, step, step)
    blocks = blocks.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, step, step)
    t = F.pad(blocks, (pl.CUNET_HALO,) * 4, mode="replicate")
    return t.permute(0, 2, 3, 1).contiguous(), ny, nx


@pytest.mark.parametrize("fault", ["se_over_the_frame", "no_halo"])
def test_planted_faults_miss_the_bar(m16, frames, ref_u8, monkeypatch,
                                     fault):
    frame = numbers(pl.upcunet2x_batch_u8(pl.unit_rgb(frames), m16),
                    ref_u8)
    if fault == "se_over_the_frame":
        monkeypatch.setattr(unet, "squeeze_excite", _se_over_the_frame)
    else:
        monkeypatch.setattr(pl, "cunet_tiles", _tiles_without_halo)
    got = pl.upcunet2x_batch_u8(pl.unit_rgb(frames), m16)
    assert not passes(got, ref_u8), numbers(got, ref_u8)
    assert numbers(got, ref_u8)[1] < frame[1] - 3.0


def test_converter_and_stream_run_the_same_step(params, frames, ref_u8,
                                                tmp_path):
    path = tmp_path / "w.pt"
    cunet.save_params(path, params)
    cfg = Config(mode="scale", arch="upcunet", model_file=str(path),
                 compute_dtype="bfloat16")
    conv = pl.Converter.from_config(cfg, device="cpu")
    assert conv.cunet.dtype == torch.bfloat16 and conv.cunet.tile == 436
    conv.cunet = unet.CunetModel.build(params, torch.bfloat16, "cpu", TILE)
    one = conv.process_bgr_u8(frames[0].numpy())
    assert passes(torch.from_numpy(one)[None], ref_u8[:1])
    sc = StreamConverter(fast=None, mode="scale", device="cpu",
                         cunet=conv.cunet)
    outs = list(sc.process_frames([frames[0].numpy(), frames[1].numpy()]))
    assert np.array_equal(outs[0], one)
    assert passes(torch.from_numpy(np.stack(outs)), ref_u8)
    stream = StreamConverter.from_cunet_params(params, device="cpu",
                                               tile=TILE)
    assert stream.cunet.tile == TILE and stream.mode == "scale"


def test_converter_draws_seeded_weights_and_picks_its_dtype():
    conv = pl.Converter.from_config(
        Config(mode="scale", arch="upcunet", model_seed=SEED), device="cpu")
    assert conv.cunet.dtype == torch.float32      # "auto" on the CPU
    assert not conv.cunet.mma
    with pytest.raises(FileNotFoundError):
        pl.Converter.from_config(Config(mode="scale", arch="upcunet"),
                                 device="cpu")
    with pytest.raises(ValueError):
        Config(mode="noise", arch="upcunet")
    with pytest.raises(ValueError):
        Config(mode="scale", arch="upcunet", scale_ratio=4.0)
    with pytest.raises(ValueError):
        Config(arch="cunet")


# -- csrc/mma.cu's entry by (ci, co) ---------------------------------------

def test_128_to_64_plain_twin_matches_conv2d(rng):
    """UpCUNet's 128 -> 64 layer, the new instance, as mma_layer_plain
    computes it from the packed weights: against F.conv2d + bias +
    LeakyReLU in f32 (1e-5), and conv3x3_mma on a CPU tensor is it."""
    x = torch.from_numpy(rng.standard_normal((2, 13, 17, 128),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 128, 64),
                                             dtype=np.float32)) * 0.04
    b = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    wp = pack_mma(w)
    assert wp.shape == (16, 9, 64, 8)
    got = stack.mma_layer_plain(x, wp, b)
    ref = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2),
                                w.permute(3, 2, 0, 1), b), 0.1)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=0,
                               atol=1e-5)
    x16, wp16 = x.to(torch.bfloat16), wp.to(torch.bfloat16)
    assert torch.equal(stack.conv3x3_mma(x16, wp16, b),
                       stack.mma_layer_plain(x16, wp16, b))
    plan = stack.mma_plan(128, 64)
    assert (plan.route, plan.kc, plan.groups) == ("resident", 16, 2)
    assert plan.resident_bytes == 9 * 128 * 64 * 2
    assert plan.smem_bytes <= stack.SMEM_MAX


def test_the_entry_gives_vgg7_layers_bit_equal(rng):
    """vgg_7's layers 2-6 through conv3x3_mma, keyed by their widths alone,
    equal mma_layer by layer index bit for bit."""
    params = [{"w": torch.from_numpy(rng.standard_normal(
        (3, 3, ci, co), dtype=np.float32)) * (1.0 / (9 * ci)) ** 0.5,
        "b": torch.zeros(co)} for ci, co in stack.WIDTHS]
    sp = stack.prep_params(params, torch.bfloat16, "cpu")
    for k in range(2, 7):
        ci, _ = stack.WIDTHS[k - 1]
        x = torch.from_numpy(rng.standard_normal((1, 11, 14, ci),
                                                 dtype=np.float32)).to(
            torch.bfloat16)
        assert torch.equal(stack.conv3x3_mma(x, sp.wm[k - 2], sp[k - 1][1]),
                           stack.mma_layer(x, sp, k))


@pytest.mark.parametrize("ci,co", [(128, 256), (256, 128), (3, 32)])
def test_the_entry_refuses_widths_without_an_instance(ci, co):
    x = torch.zeros((1, 5, 5, ci), dtype=torch.bfloat16)
    wp = torch.zeros((max(ci // 8, 1), 9, co, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        stack.conv3x3_mma(x, wp, torch.zeros(co))


class _FakeLib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


def test_launch_counts_by_shape_and_route():
    """One launch of the persistent kernel a layer, keyed by (ci, co): an
    UpCUNet layer's counts under MID_LAUNCHES and MMA_SHAPES by (ci, co,
    route), and under no stack call's count."""
    calls = []
    run = object.__new__(stack._Launcher)
    run.kind, run.events, run.step = None, None, 0
    run.libs = {"mma": _FakeLib(calls)}
    run.bf16, run.stream = 1, 0
    stack.reset_launches()
    x = torch.zeros(1, dtype=torch.bfloat16)
    for ci, co in ((128, 64), (64, 64), (64, 64)):
        wp = torch.zeros((ci // 8, 9, co, 8), dtype=torch.bfloat16)
        assert run.mma(x, wp, torch.zeros(co), x, 2, 30, 30, "t") == \
            "resident"
    assert [c[1][:3] for c in calls] == [(1, 128, 64), (1, 64, 64),
                                         (1, 64, 64)]
    assert calls[0][1][-2] == stack.mma_plan(128, 64).smem_bytes
    assert stack.LAUNCHES == 0 and not any(stack.KERNEL_LAUNCHES.values())
    assert stack.MMA_SHAPES == {(128, 64, "resident"): 1,
                                (64, 64, "resident"): 2}
    assert stack.MID_LAUNCHES["mma"] == stack.MID_LAUNCHES[
        "mma_resident"] == 3
    stack.reset_launches()
    assert stack.MMA_SHAPES == {} and stack.MID_LAUNCHES["mma"] == 0


def test_the_cli_converts_with_upcunet(tmp_path):
    """--arch upcunet with --model_seed on the CPU: two inputs ride the
    stream, byte for byte as a StreamConverter on Converter's model gives
    them, each twice its size and at the f32 bar of Converter's own
    conversion of it alone (f32 sums over a batch of one tile and of two
    may round a value across a u8 tie)."""
    from waifu2x_torch import cli
    from waifu2x_torch import io as w2x_io
    rng = np.random.default_rng(9)
    paths = []
    for k, (h, w) in enumerate(((20, 26), (20, 26))):
        p = str(tmp_path / f"in{k}.png")
        w2x_io.imwrite_bgr(p, rng.integers(0, 256, (h, w, 3),
                                           dtype=np.uint8))
        paths.append(p)
    assert cli.main(["-i", *paths, "-m", "scale", "--arch", "upcunet",
                     "--model_seed", str(SEED), "--device", "cpu"]) == 0
    outs = [w2x_io.imread_bgr(w2x_io.auto_output_name(p, "scale", 1, 2.0))
            for p in paths]
    assert [o.shape for o in outs] == [(40, 52, 3)] * 2
    conv = pl.Converter.from_config(
        Config(mode="scale", arch="upcunet", model_seed=SEED), device="cpu")
    ins = [w2x_io.imread_bgr(p) for p in paths]
    sc = StreamConverter(fast=None, mode="scale", device="cpu",
                         cunet=conv.cunet)
    assert all(np.array_equal(a, b)
               for a, b in zip(outs, sc.process_frames(ins)))
    for out, img in zip(outs, ins):
        d = np.abs(out.astype(int) - conv.process_bgr_u8(img).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    assert cli.main(["-i", paths[0], "-m", "noise", "--arch", "upcunet",
                     "--model_seed", "1", "--device", "cpu"]) == 1


# -- the library layers' epilogue (csrc/epi.cu) -----------------------------

# the forward pass's library layers in order: (key, mode, channels, crop)
EPILOGUES = [
    ("unet1.conv1.conv.0", "bias_leaky", 32, 0),
    ("unet1.conv1_down", "bias_leaky", 64, 0),
    ("unet1.conv2_up", "bias_leaky_skip", 64, 4),
    ("unet1.conv_bottom", "bias", 3, 0),
    ("unet2.conv1.conv.0", "bias_leaky", 32, 0),
    ("unet2.conv1_down", "bias_leaky", 64, 0),
    ("unet2.conv2_down", "bias_leaky", 128, 0),
    ("unet2.conv3.conv.0", "bias_leaky", 256, 0),
    ("unet2.conv3.conv.2", "bias_leaky", 128, 0),
    ("unet2.conv3_up", "bias_leaky_skip", 128, 4),
    ("unet2.conv4_up", "bias_leaky_skip", 64, 16),
    ("unet2.conv_bottom", "bias", 3, 0)]


def composite(y, b, leaky, skip=None, crop=0):
    """The three PyTorch passes the epilogue replaces, on bf16 tensors: the
    bias add, F.leaky_relu, crop_add."""
    t = y + b
    if leaky:
        t = F.leaky_relu(t, unet.LEAKY)
    return t if skip is None else unet.crop_add(skip, crop, t)


def bf16_values(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("c", unet.EPI_CHANNELS)
@pytest.mark.parametrize("mode,crop", [("bias", 0), ("bias_leaky", 0),
                                       ("bias_leaky_skip", 4),
                                       ("bias_leaky_skip", 16)])
def test_epilogue_plain_is_the_composite_bit_for_bit(mode, crop, c):
    """cunet_epilogue_plain (and the wrapper on the CPU, in place) against
    the bias add, LeakyReLU and crop_add on the same bf16 values: every bit
    equal, at values whose sums round (a wide bias against a narrow y)."""
    g = torch.Generator().manual_seed(c * 100 + crop)
    y = bf16_values(g, 2, 7, 9, c, scale=3.0)
    b = bf16_values(g, c, scale=0.7)
    leaky = "leaky" in mode
    skip = bf16_values(g, 2, 7 + 2 * crop, 9 + 2 * crop, c) if crop else None
    want = composite(y, b, leaky, skip, crop).view(torch.int16)
    plain = unet.cunet_epilogue_plain(y, b, leaky, skip, crop)
    assert torch.equal(plain.view(torch.int16), want)
    z = y.clone()
    assert unet.cunet_epilogue(z, b, leaky, skip, crop) is z
    assert torch.equal(z.view(torch.int16), want)
    assert unet.epi_mode(leaky, skip is not None) == mode


def _record_epilogues(monkeypatch):
    calls = []
    real = unet.cunet_epilogue

    def record(y, b, leaky, skip=None, crop=0):
        calls.append((b, unet.epi_mode(leaky, skip is not None), y.shape[3],
                      crop))
        return real(y, b, leaky, skip, crop)

    monkeypatch.setattr(unet, "cunet_epilogue", record)
    return calls


def test_the_forward_pass_calls_the_epilogue_at_every_library_layer(
        m16, params, monkeypatch):
    """Two tiles through a bf16 forward pass: twelve epilogues, one a
    library layer, each with its layer's bias, mode, width and crop (7
    bias + leaky, 3 with the skip, 2 bias alone); the f32 model calls
    none."""
    calls = _record_epilogues(monkeypatch)
    x = torch.rand((2, TILE, TILE, 3), generator=torch.Generator()
                   .manual_seed(3)).to(torch.bfloat16)
    unet.upcunet_tiles(x, m16)
    assert [(mode, c, crop) for _, mode, c, crop in calls] == [
        e[1:] for e in EPILOGUES]
    assert all(b is m16.conv[key][1] for (b, *_), (key, *_) in
               zip(calls, EPILOGUES))
    assert sorted(m16.conv) == sorted(e[0] for e in EPILOGUES)
    calls.clear()
    m32 = unet.CunetModel.build(params, torch.float32, "cpu", TILE)
    unet.upcunet_tiles(x.float(), m32)
    assert calls == []


def test_the_forward_pass_is_the_composites_bit_for_bit(m16, monkeypatch):
    """The bf16 forward pass with the epilogue against the same pass with
    the three PyTorch passes in its place: every output bit equal."""
    x = torch.rand((2, TILE, TILE, 3), generator=torch.Generator()
                   .manual_seed(4)).to(torch.bfloat16)
    got = unet.upcunet_tiles(x, m16)
    monkeypatch.setattr(unet, "cunet_epilogue",
                        lambda y, b, leaky, skip=None, crop=0:
                        composite(y, b, leaky, skip, crop))
    want = unet.upcunet_tiles(x, m16)
    assert torch.equal(got, want)


def _bad(case):
    g = torch.Generator().manual_seed(5)
    y = bf16_values(g, 2, 6, 6, 64)
    b = bf16_values(g, 64)
    skip = bf16_values(g, 2, 14, 14, 64)
    if case == "strided":
        return dict(y=y.permute(0, 2, 1, 3), b=b)
    if case == "f32":
        return dict(y=y.float(), b=b)
    if case == "bias":
        return dict(y=y, b=b[:32])
    if case == "skip":
        return dict(y=y, b=b, skip=skip, crop=2)
    if case == "width":
        return dict(y=y[..., :48].contiguous(), b=b[:48])
    return dict(y=y, b=b, crop=4)


@pytest.mark.parametrize("case", ["strided", "f32", "bias", "skip", "width",
                                  "crop_alone"])
def test_the_epilogue_refuses(case):
    """A non-contiguous or non-bf16 y, a bias of the wrong length, a skip
    that is not y plus twice the crop, a width the kernel has no path for,
    a crop with no skip."""
    kw = _bad(case)
    with pytest.raises((ValueError, TypeError)):
        unet.cunet_epilogue(kw.pop("y"), kw.pop("b"), True, **kw)


def test_epilogue_launches_are_counted_by_mode():
    """EPI_LAUNCHES counts the card's launches only; its modes are
    epi_mode's."""
    unet.reset_epi_launches()
    g = torch.Generator().manual_seed(6)
    unet.cunet_epilogue(bf16_values(g, 1, 4, 4, 32), bf16_values(g, 32), True)
    assert set(unet.EPI_LAUNCHES) == {
        unet.epi_mode(a, b) for a in (False, True) for b in (False, True)}
    assert not any(unet.EPI_LAUNCHES.values())


def test_epilogue_roofline_reader():
    """kern.cunet_epi_roofline: 43.0 GB a 4 x 1080p dispatch (the library
    layers' 142.2 M outputs a tile read and written, the three skips' 74.0 M
    read), over cunet_epilogue's device time; None where no trace holds
    the kernel."""
    from benchmark import cunet_counts, harness, trace as btrace
    read = harness.load_reader("kern.cunet_epi_roofline")
    call = cunet_counts.CunetCall("bfloat16", 4, 1080, 1920, 436)
    mod = _load(ROOT / "benchmark" / "metrics" /
                "kern.cunet_epi_roofline.py")
    assert call.tiles * mod.tile_bytes(call) == 60 * 2 * (
        2 * 142_197_440 + 73_975_296)
    assert call.tiles * mod.tile_bytes(call) / 1e9 == pytest.approx(
        43.0, abs=0.05)
    epi = "void (anonymous namespace)::cunet_epilogue<64, 3>(" \
          "__nv_bfloat16*, __nv_bfloat16 const*, __nv_bfloat16 const*, " \
          "(anonymous namespace)::EpiShape)"
    run = harness.Run(
        cell="upcunet2x.b4_1080", config={}, workload={}, setup_s=1.0,
        window_s=1.0, dispatches=2, out_px=1, latency_ms=[1.0],
        calls={call: 2}, counters={}, peak_mem_bytes=1,
        trace=btrace.Trace(1.0, [(epi, 0.0, 0.04)], []),
        kernels=frozenset({"cunet_epilogue"}))
    assert read(run) == pytest.approx(
        100 * 2 * call.tiles * mod.tile_bytes(call) / 3.35e12 / 0.04)
    run.trace = btrace.Trace(1.0, [], [])
    assert read(run) is None
