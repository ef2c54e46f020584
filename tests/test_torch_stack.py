"""The conv-stack wrapper (waifu2x_torch.ops.stack) on the CPU, where it
takes its plain PyTorch version, against the JAX package's Pallas kernel in
interpret mode and against its reference conv stack.

Tolerances: f32 within 3e-5, the JAX kernel suite's own bar
(tests/test_pallas_stack.py); bf16 storage >= 50 dB PSNR (peak 1) against
f32, the fidelity bar for bf16 kernel paths. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

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
from waifu2x_torch.ops.s2d import d2s

torch.set_num_threads(2)

SHAPES = [(16, 16, (8, 16)), (13, 22, (16, 16)), (9, 9, (16, 16))]


@pytest.fixture(scope="module")
def params_np():
    return as_numpy(init_params(jax.random.PRNGKey(3), WAIFU2X_7LAYER))


@pytest.fixture(scope="module")
def sp32(params_np):
    return stack.prep_params(params_from_numpy(params_np), torch.float32,
                             "cpu")


@pytest.mark.parametrize("hl,wl,tile", SHAPES)
def test_stack_scale_matches_pallas_interpret(params_np, sp32, rng, hl, wl,
                                              tile):
    ylow = rng.random((2, hl, wl), dtype=np.float32)
    kp, spec = jprep_params(params_np, scale_input=True, dtype=jnp.float32)
    ref = np.asarray(jstack_scale(jnp.asarray(ylow), kp, spec, tile=tile,
                                  interpret=True))
    got = stack.stack_scale(torch.from_numpy(ylow), sp32)
    assert got.shape == (2, hl, wl, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("hl,wl", [(s[0], s[1]) for s in SHAPES] + [(5, 31)])
def test_stack_scale_matches_convert_plane(params_np, sp32, rng, hl, wl):
    ylow = rng.random((2, hl, wl), dtype=np.float32)
    up = np.repeat(np.repeat(ylow, 2, axis=1), 2, axis=2)
    ref = np.asarray(jconvert_plane(jnp.asarray(up), params_np,
                                    precision="highest"))
    got = d2s(stack.stack_scale(torch.from_numpy(ylow), sp32))[..., 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5)


def test_bf16_plain_fidelity(rng):
    """bf16 storage (activations rounded after every layer, f32 sums) of
    the shipped weights on an image-like plane: >= 50 dB against f32."""
    params = load_model_json(Path(__file__).resolve().parents[1] / "models"
                             / "scale2.0x_demo.json")
    yy, xx = np.mgrid[0:24, 0:40].astype(np.float32)
    ylow = (0.5 + 0.3 * np.sin(yy / 5) * np.cos(xx / 7)
            + 0.02 * rng.standard_normal((24, 40))).astype(np.float32)[None]
    y32 = stack.stack_scale(torch.from_numpy(ylow),
                            stack.prep_params(params, torch.float32, "cpu"))
    y16 = stack.stack_scale(torch.from_numpy(ylow).to(torch.bfloat16),
                            stack.prep_params(params, torch.bfloat16, "cpu"))
    assert y16.dtype == torch.bfloat16
    mse = torch.mean((y16.double() - y32.double()) ** 2).item()
    assert 10 * np.log10(1.0 / mse) >= 50.0


def test_prep_params_layout(params_np):
    sp = stack.prep_params(params_from_numpy(params_np), torch.bfloat16,
                           "cpu")
    for (w, b), p, (ci, co) in zip(sp, params_np, stack.WIDTHS):
        assert w.shape == (ci, 9, co) and w.dtype == torch.bfloat16
        assert b.dtype == torch.float32
        # w[ci, dy*3 + dx, co] == HWIO[dy, dx, ci, co]
        torch.testing.assert_close(
            w[:, 5].float(), torch.from_numpy(p["w"][1, 2].copy())
            .to(torch.bfloat16).float(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="flagship"):
        stack.prep_params(params_from_numpy(params_np[:3]))


def _bad_inputs(sp32):
    y = torch.rand(1, 8, 8)
    sp16 = tuple((w.to(torch.bfloat16), b) for w, b in sp32)
    return {
        "float64": (TypeError, y.double(), sp32),
        "int": (TypeError, (y * 9).int(), sp32),
        "2d": (ValueError, y[0], sp32),
        "4d": (ValueError, y[None], sp32),
        "empty": (ValueError, y[:, :0], sp32),
        "non_contiguous": (ValueError, torch.rand(1, 8, 16)[..., ::2], sp32),
        "weight_dtype": (TypeError, y, sp16),
        "layers": (ValueError, y, sp32[:6]),
        "weight_shape": (ValueError, y, ((sp32[0][0][:, :4], sp32[0][1]),)
                         + sp32[1:]),
    }


@pytest.mark.parametrize("case", ["float64", "int", "2d", "4d", "empty",
                                  "non_contiguous", "weight_dtype", "layers",
                                  "weight_shape"])
def test_wrapper_rejects_bad_input(sp32, case):
    err, y, sp = _bad_inputs(sp32)[case]
    with pytest.raises(err):
        stack.stack_scale(y, sp)


def test_no_launches_on_cpu(sp32, rng):
    before = stack.LAUNCHES
    stack.stack_scale(torch.from_numpy(rng.random((1, 6, 7),
                                                  dtype=np.float32)), sp32)
    stack.stack_scale_plain(torch.rand(1, 6, 7), sp32)
    assert stack.LAUNCHES == before == 0
