"""The port's sharded train step (train.make_sharded_train_step) on 8 CPU
positions of a ("dp", "sp") mesh, (2, 4) and (1, 8), against the port's
single-device step (within 1e-6, the bar of the JAX package's
test_sharded_step_matches_single) and against the JAX package's
single-device step (within 1e-5, test_sharded_step_honors_custom_loss's
bar), for the MSE loss and for the int8 QAT loss, whose per-sample scale
the step reduces over "sp" first; with uneven column shares (18 output
columns over sp = 4) and empty ones. The 2-process form (gradients
all-reduced over gloo) runs in tests/test_torch_multihost.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import ModelSpec as JModelSpec
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.train import data as jdata
from waifu2x_tpu.train import qat as jqat
from waifu2x_tpu.train import train as jtrain
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.parallel import mesh as m
from waifu2x_torch.parallel import multihost
from waifu2x_torch.train import qat, train

torch.set_num_threads(2)

JSMALL = JModelSpec.from_widths([1, 4, 4, 1])
MESHES = [(2, 4), (1, 8)]


@pytest.fixture(autouse=True)
def eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(m, "CPU_DEVICES", 8)


def _jparams(seed, spec):
    return as_numpy(init_params(jax.random.PRNGKey(seed), spec))


def _port(jp):
    return train.trainable(params_from_numpy(jp), "cpu")


def _close(a_params, b_params, atol):
    for a, b in zip(a_params, b_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                a[k].detach().numpy(),
                b[k].detach().numpy() if isinstance(b[k], torch.Tensor)
                else np.asarray(b[k]), rtol=0, atol=atol)


def _steps(jp, x, y, mesh, loss=None, jloss=None):
    """(sharded, single) port steps and the JAX single step from jp."""
    opt = train.Optimizer(1e-3)
    out = []
    for sharded in (True, False):
        p = _port(jp)
        make = (lambda *a: train.make_sharded_train_step(mesh, *a)) if (
            sharded) else train.make_train_step
        p, st, value = make(opt, "highest", loss)(p, opt.init(p), x, y)
        out.append((p, float(value)))
    jopt = optax.adam(1e-3)
    jp1, _, jl = jtrain.make_train_step(jopt, "highest", loss=jloss)(
        jp, jopt.init(jp), jnp.asarray(x), jnp.asarray(y))
    return out[0], out[1], (jp1, float(jl))


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x8"])
def test_sharded_step_matches_single(rng, shape):
    mesh = multihost.global_mesh(*shape, device="cpu")
    imgs = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
            for _ in range(3)]
    x, y = jdata.make_batch(imgs, 4, "scale", rng,
                            jdata.PairOptions(crop_size=32, offset=3))
    jp = _jparams(1, JSMALL)
    (ps, ls), (p1, l1), (pj, lj) = _steps(jp, x, y, mesh)
    assert abs(ls - l1) < 1e-6
    _close(ps, p1, 1e-6)
    assert abs(ls - lj) < 1e-5
    _close(ps, pj, 1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x8"])
def test_sharded_step_honors_custom_loss(rng, shape):
    """The QAT loss on the flagship, 18 output columns split over "sp" (4
    or 8, unevenly): the whole-sample activation scale reduced over the
    shares first, so the sharded loss is the single step's; it differs from
    the sharded MSE step's."""
    mesh = multihost.global_mesh(*shape, device="cpu")
    jp = _jparams(1, JFLAGSHIP)
    x = rng.random((4, 30, 32, 1), dtype=np.float32)
    y = rng.random((4, 16, 18, 1), dtype=np.float32)
    (ps, ls), (p1, l1), (_, lj) = _steps(
        jp, x, y, mesh, qat.make_qat_l6_loss(8.0), jqat.make_qat_l6_loss(8.0))
    assert abs(ls - l1) < 1e-6
    assert abs(ls - lj) < 1e-5
    (_, l_mse), _, _ = _steps(jp, x, y, mesh)
    assert abs(ls - l_mse) > 1e-7
    # without the reduction each share would take its own maximum
    loss = qat.make_qat_l6_loss(8.0)
    p = _port(jp)
    xs = torch.from_numpy(x)
    whole = loss.l6_absmax(p, xs)
    part = loss.l6_absmax(p, xs[:, :, :19])
    assert (part <= whole).all() and (part < whole).any()


def test_empty_shares_and_column_split(rng):
    """A crop whose outputs are fewer than the "sp" positions: the empty
    shares take no part, and the step still equals the single step."""
    assert train.column_split(18, 4) == [(0, 4), (4, 9), (9, 13), (13, 18)]
    assert train.column_split(3, 8)[:3] == [(0, 0), (0, 0), (0, 1)]
    mesh = multihost.global_mesh(1, 8, device="cpu")
    jp = _jparams(2, JSMALL)
    x = rng.random((2, 12, 9, 1), dtype=np.float32)
    y = rng.random((2, 6, 3, 1), dtype=np.float32)
    (ps, ls), (p1, l1), _ = _steps(jp, x, y, mesh)
    assert abs(ls - l1) < 1e-6
    _close(ps, p1, 1e-6)


def test_train_loop_on_a_mesh_matches_one_device(rng):
    imgs = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
            for _ in range(3)]
    batches = [jdata.make_batch(imgs, 4, "scale", rng,
                                jdata.PairOptions(crop_size=32, offset=3))
               for _ in range(3)]
    jp = _jparams(3, JSMALL)
    cfg = train.TrainConfig(batch_size=4, ema_decay=0.5, clip_norm=0.1,
                            decay_steps=3)
    ps, ls, es = train.train_loop(jp, batches, cfg, device="cpu",
                                  mesh=multihost.global_mesh(2, 4,
                                                             device="cpu"))
    p1, l1, e1 = train.train_loop(jp, batches, cfg, device="cpu")
    np.testing.assert_allclose(ls, l1, rtol=0, atol=1e-6)
    _close(ps, p1, 1e-6)
    _close(es, e1, 1e-6)


def test_sharded_step_rejects_a_ragged_batch(rng):
    mesh = multihost.global_mesh(2, 4, device="cpu")
    p = _port(_jparams(0, JSMALL))
    opt = train.Optimizer(1e-3)
    step = train.make_sharded_train_step(mesh, opt)
    with pytest.raises(ValueError, match="dp rows"):
        step(p, opt.init(p), np.zeros((3, 16, 16, 1), np.float32),
             np.zeros((3, 10, 10, 1), np.float32))
