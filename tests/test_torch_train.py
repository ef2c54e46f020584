"""The port's training (waifu2x_torch/train/) against the JAX package's on
the CPU: pair generation bit for bit, the MSE loss within 1e-6, one Adam
step and three steps under warmup + cosine + clipping within 1e-5, the
schedules within 1e-7 relative, clipping, train_loop with its EMA and eval
hook within 1e-5, the int8 QAT loss and its gradient within 1e-5, and
checkpoints that either package resumes. The inputs come from
np.random.default_rng; the JAX params are carried across with
models.weights.params_from_numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waifu2x_tpu.models.srcnn import WAIFU2X_7LAYER as JFLAGSHIP
from waifu2x_tpu.models.srcnn import ModelSpec as JModelSpec
from waifu2x_tpu.models.srcnn import as_numpy, init_params
from waifu2x_tpu.train import checkpoint as jckpt
from waifu2x_tpu.train import data as jdata
from waifu2x_tpu.train import qat as jqat
from waifu2x_tpu.train import train as jtrain
from waifu2x_torch.models.weights import params_from_numpy
from waifu2x_torch.train import checkpoint as ckpt
from waifu2x_torch.train import data
from waifu2x_torch.train import qat
from waifu2x_torch.train import train

torch.set_num_threads(2)

JSMALL = JModelSpec.from_widths([1, 4, 4, 1])   # offset 3
OPTS = data.PairOptions(crop_size=32, offset=3)
JOPTS = jdata.PairOptions(crop_size=32, offset=3)


def _images(rng, n=3):
    return [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
            for _ in range(n)]


def _jparams(seed, spec=JSMALL):
    return as_numpy(init_params(jax.random.PRNGKey(seed), spec))


def _port(jp):
    return train.trainable(params_from_numpy(jp), "cpu")


def _close(port, jp, atol):
    for a, b in zip(port, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].detach().numpy(), np.asarray(b[k]),
                                       rtol=0, atol=atol)


def _batch(rng, n=4, spec="small"):
    if spec == "small":
        return data.make_batch(_images(rng), n, "scale", rng, OPTS)
    x = rng.random((n, 30, 32, 1), dtype=np.float32)
    y = rng.random((n, 16, 18, 1), dtype=np.float32)
    return x, y


# --- data.py: bit for bit -------------------------------------------------

@pytest.mark.parametrize("kind,level,opts", [
    ("scale", 1, {}),
    ("scale", 1, {"downscale_filters": ("box", "blackman"), "noise": True,
                  "noise_ratio": 0.7, "color_augment": False}),
    ("noise", 1, {}),
    ("noise", 2, {}),
], ids=["scale", "scale_pool_noise", "noise1", "noise2"])
def test_make_batch_bit_equal(kind, level, opts):
    imgs = _images(np.random.default_rng(9))
    got = data.make_batch(imgs, 6, kind, np.random.default_rng(5),
                          data.PairOptions(crop_size=32, offset=3, **opts),
                          noise_level=level)
    want = jdata.make_batch(imgs, 6, kind, np.random.default_rng(5),
                            jdata.PairOptions(crop_size=32, offset=3, **opts),
                            noise_level=level)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_pairs_and_filters_bit_equal():
    img = _images(np.random.default_rng(2))[0]
    for level in (1, 2):
        for g, w in zip(data.jpeg_pair(img, level, np.random.default_rng(4),
                                       OPTS),
                        jdata.jpeg_pair(img, level, np.random.default_rng(4),
                                        JOPTS)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(data.scale_pair(img, np.random.default_rng(4), OPTS),
                    jdata.scale_pair(img, np.random.default_rng(4), JOPTS)):
        np.testing.assert_array_equal(g, w)
    f = np.random.default_rng(0).random((16, 18, 3)).astype(np.float32)
    for name in ("box_downscale2", "blackman_downscale2", "rgb_luma"):
        np.testing.assert_array_equal(getattr(data, name)(f),
                                      getattr(jdata, name)(f))
    with pytest.raises(ValueError):
        data.jpeg_pair(img, 3, np.random.default_rng(0), OPTS)


# --- the loss and the steps ---------------------------------------------

@pytest.mark.parametrize("spec", ["small", "flagship"])
def test_loss_fn_matches_jax(rng, spec):
    jp = _jparams(1, JSMALL if spec == "small" else JFLAGSHIP)
    x, y = _batch(rng, 4, spec)
    with torch.no_grad():
        got = train.loss_fn(_port(jp), torch.from_numpy(x),
                            torch.from_numpy(y))
    want = float(jtrain.loss_fn(jp, jnp.asarray(x), jnp.asarray(y)))
    assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("spec", ["small", "flagship"])
def test_one_adam_step_matches_jax(rng, spec):
    """At the reference's rate, 2.5e-4 (TrainConfig's default). Adam's first
    update is lr * g / (|g| + 1e-8): where |g| is near 1e-8 (the flagship
    at this seed has weight gradients down to 7e-9) a difference of 1e-10
    between the two packages' f32 gradients (they agree within 1.2e-7
    everywhere) moves the update by about lr / 100, so the bar scales with
    the rate: at 1e-3, one weight of 147456 lands 1.26e-5 from JAX's."""
    jp = _jparams(2, JSMALL if spec == "small" else JFLAGSHIP)
    x, y = _batch(rng, 4, spec)
    opt = jtrain.TrainConfig().make_optimizer()
    jp1, _, jl = jtrain.make_train_step(opt)(jp, opt.init(jp),
                                             jnp.asarray(x), jnp.asarray(y))
    p = _port(jp)
    popt = train.TrainConfig().make_optimizer()
    p, st, pl_ = train.make_train_step(popt)(p, popt.init(p), x, y)
    assert abs(float(pl_) - float(jl)) <= 1e-6
    assert st.count == 1
    _close(p, jp1, 1e-5)


def test_three_steps_warmup_cosine_clip_match_jax(rng):
    """Warmup from 0 (so the first update moves nothing), cosine decay and
    a clip norm that every step's gradient exceeds."""
    cfg = dict(learning_rate=3e-3, decay_steps=5, warmup_steps=2,
               clip_norm=0.05)
    jp = _jparams(3)
    jopt = jtrain.TrainConfig(**cfg).make_optimizer()
    jstep, jst = jtrain.make_train_step(jopt), jopt.init(jp)
    p = _port(jp)
    popt = train.TrainConfig(**cfg).make_optimizer()
    pstep, pst = train.make_train_step(popt), popt.init(p)
    for k in range(3):
        x, y = _batch(rng, 4)
        jp, jst, jl = jstep(jp, jst, jnp.asarray(x), jnp.asarray(y))
        p, pst, pl_ = pstep(p, pst, x, y)
        assert abs(float(pl_) - float(jl)) <= 1e-6
        _close(p, jp, 1e-5)
        if k == 0:    # rate 0 at the first update
            _close(p, _jparams(3), 0.0)


CONFIGS = [(2.5e-4, 20, 0, 0.05), (2.5e-4, 20, 5, 0.05), (1e-3, 400, 37, 0.1),
           (3e-3, 7, 3, 0.5), (5e-5, 1, 0, 0.05)]


@pytest.mark.parametrize("lr,decay,warmup,ratio", CONFIGS)
def test_schedule_matches_optax(lr, decay, warmup, ratio):
    """Every step's rate against optax's schedule functions evaluated in
    float64 (jax.enable_x64), within 1e-7 relative. Evaluated in float32,
    as optax's optimizer runs them, they carry f32 rounding: 4.5e-7 from
    the exact rate at most over these configurations (XLA's f32 cos is
    one ulp from a correctly rounded one at about a sixth of the counts,
    and near the end of the decay 1 + cos cancels), so against that
    evaluation the port's rate (a Python float) is held to 1e-6."""
    popt = train.TrainConfig(learning_rate=lr, decay_steps=decay,
                             warmup_steps=warmup,
                             lr_min_ratio=ratio).make_optimizer()
    assert popt.scheduled

    def sched():
        if warmup:
            return optax.warmup_cosine_decay_schedule(
                0.0, lr, warmup, decay, lr * ratio)
        return optax.cosine_decay_schedule(lr, decay, ratio)

    with jax.enable_x64(True):
        want64 = [float(sched()(t)) for t in range(decay + 6)]
    want32 = [float(sched()(t)) for t in range(decay + 6)]
    for t in range(decay + 6):
        got = popt.rate(t)
        assert abs(got - want64[t]) <= 1e-7 * abs(want64[t]), (t, got)
        assert abs(got - want32[t]) <= 1e-6 * abs(want32[t])
    if warmup:
        assert popt.rate(0) == 0.0
    assert train.TrainConfig().make_optimizer().rate(10) == 2.5e-4


@pytest.mark.parametrize("max_norm", [0.01, 1e3], ids=["above", "below"])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(7)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2,))]
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(gs))
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = train.clip_by_global_norm(got, max_norm)
    assert abs(float(norm) - float(optax.global_norm(gs))) <= 1e-6
    for g, w, orig in zip(got, want, gs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if max_norm > 1:
            np.testing.assert_array_equal(g.numpy(), orig)


def test_train_loop_matches_jax(rng):
    """4 batches, EMA 0.9, eval every 2 steps: the hook's calls, the
    losses, the params and the EMA."""
    batches = [data.make_batch(_images(rng), 2, "scale", rng, OPTS)
               for _ in range(4)]
    jp = _jparams(0)
    cfg = dict(batch_size=2, ema_decay=0.9, learning_rate=2e-3)
    calls, jcalls = [], []
    got = train.train_loop(jp, batches, train.TrainConfig(**cfg),
                           eval_every=2, device="cpu",
                           eval_fn=lambda s, p, e: calls.append(
                               (s, e is not None)))
    want = jtrain.train_loop(jp, batches, jtrain.TrainConfig(**cfg),
                             eval_every=2,
                             eval_fn=lambda s, p, e: jcalls.append(
                                 (s, e is not None)))
    assert calls == jcalls == [(2, True), (4, True)]
    assert len(got) == 3 and len(got[1]) == 4
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    _close(got[0], want[0], 1e-5)
    _close(got[2], want[2], 1e-5)
    d = max(float((a - b).detach().abs().max()) for a, b in zip(
        train.leaves(got[0]), train.leaves(got[2])))
    assert d > 0     # the EMA lags the params
    # the caller's params are untouched, and without EMA two values return
    out = train.train_loop(params_from_numpy(jp), batches[:1],
                           train.TrainConfig(batch_size=2), device="cpu")
    assert len(out) == 2


def test_loss_falls():
    """100 Adam steps on one batch at least halve the MSE."""
    rng = np.random.default_rng(1234)
    p = _port(_jparams(0))
    x, y = data.make_batch(_images(rng), 4, "scale", rng, OPTS)
    opt = train.Optimizer(5e-3)
    st, step = opt.init(p), train.make_train_step(opt)
    with torch.no_grad():
        first = float(train.loss_fn(p, torch.from_numpy(x),
                                    torch.from_numpy(y)))
    for _ in range(100):
        p, st, value = step(p, st, x, y)
    assert float(value) < first * 0.5


# --- the QAT loss -----------------------------------------------------------

def test_qat_loss_and_gradient_match_jax(rng):
    jp = _jparams(0, JFLAGSHIP)
    x = rng.random((2, 30, 30, 1), dtype=np.float32)
    y = rng.random((2, 16, 16, 1), dtype=np.float32)
    jloss = jqat.make_qat_l6_loss(mu=4.0)
    jv, jg = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(x),
                                                jnp.asarray(y), "highest"))(jp)
    p = _port(jp)
    v = qat.make_qat_l6_loss(mu=4.0)(p, torch.from_numpy(x),
                                     torch.from_numpy(y))
    v.backward()
    assert abs(float(v) - float(jv)) <= 1e-5
    for a, b in zip(p, jg):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].grad.numpy(), np.asarray(b[k]),
                                       rtol=0, atol=1e-5)
    assert float(p[5]["w"].grad.abs().max()) > 0
    # the coupling term is present: the loss differs from the task MSE
    assert abs(float(v) - float(train.loss_fn(p, torch.from_numpy(x),
                                              torch.from_numpy(y)))) > 1e-7


def test_qat_absmax_hook_is_the_whole_sample_maximum(rng):
    """absmax= set to the per-sample maximum that l6_absmax reports gives
    the loss the unsplit call computes."""
    p = _port(_jparams(4, JFLAGSHIP))
    x = torch.from_numpy(rng.random((2, 30, 30, 1), dtype=np.float32))
    y = torch.from_numpy(rng.random((2, 16, 16, 1), dtype=np.float32))
    loss = qat.make_qat_l6_loss(2.0)
    m = loss.l6_absmax(p, x)
    assert m.shape == (2,) and not m.requires_grad
    assert float(loss(p, x, y, absmax=m)) == float(loss(p, x, y))
    assert float(loss(p, x, y, absmax=2 * m)) != float(loss(p, x, y))


def test_qat_steps_run_and_match_jax_at_the_first(rng):
    """Three steps with the QAT loss on random data at 1e-3 (JAX's
    test_qat_loss_trains): the first step's loss within 1e-5 of JAX's, every
    loss and the final quantisation gap finite. Later losses are not
    compared: the first update at this rate throws the random model from
    0.36 to 60 in loss on both sides, and Adam's first update,
    lr * g / (|g| + 1e-8), carries the two packages' f32 differences in
    gradients of 1e-8 (the fake-quant's rounding moves some by a relative
    1e-2) into the weights; the gradients themselves are held above."""
    jp = _jparams(1, JFLAGSHIP)
    x = rng.random((2, 30, 30, 1), dtype=np.float32)
    y = rng.random((2, 16, 16, 1), dtype=np.float32)
    opt = optax.adam(1e-3)
    _, _, jl = jtrain.make_train_step(opt, "highest",
                                      loss=jqat.make_qat_l6_loss(2.0))(
        jp, opt.init(jp), jnp.asarray(x), jnp.asarray(y))
    p = _port(jp)
    popt = train.Optimizer(1e-3)
    pstep = train.make_train_step(popt, "highest", qat.make_qat_l6_loss(2.0))
    pst = popt.init(p)
    losses = []
    for _ in range(3):
        p, pst, value = pstep(p, pst, x, y)
        losses.append(float(value))
    assert abs(losses[0] - float(jl)) <= 1e-5
    assert np.isfinite(losses).all()
    assert np.isfinite(qat.l6_quant_gap_db(p, torch.from_numpy(x)))


# --- checkpoints --------------------------------------------------------------

def _trained(rng, cfg, steps=2):
    """(JAX params, JAX opt state, port params, port opt state, batches)
    after `steps` equal updates on both sides."""
    jp = _jparams(3)
    jopt = jtrain.TrainConfig(**cfg).make_optimizer()
    jst = jopt.init(jp)
    p = _port(jp)
    popt = train.TrainConfig(**cfg).make_optimizer()
    pst = popt.init(p)
    batches = [_batch(rng, 2) for _ in range(steps + 1)]
    for x, y in batches[:steps]:
        jp, jst, _ = jtrain.make_train_step(jopt)(jp, jst, jnp.asarray(x),
                                                  jnp.asarray(y))
        p, pst, _ = train.make_train_step(popt)(p, pst, x, y)
    return jp, jst, jopt, p, pst, popt, batches


SCHED = [dict(learning_rate=1e-3), dict(learning_rate=1e-3, decay_steps=8,
                                        warmup_steps=2, clip_norm=0.5)]


@pytest.mark.parametrize("cfg", SCHED, ids=["constant", "scheduled"])
def test_port_checkpoint_loads_in_jax(tmp_path, rng, cfg):
    jp, jst, jopt, p, pst, _, _ = _trained(rng, cfg)
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, p, pst, step=2)
    lp, lst, step = jckpt.load_checkpoint(path, jp, jopt.init(jp))
    assert step == 2
    for a, b in zip(jax.tree.leaves({"params": lp, "opt_state": lst}),
                    jax.tree.leaves({"params": jp, "opt_state": jst})):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_leaf_count_of_the_flagship(tmp_path):
    """43 leaves for the 7-layer model, 44 with a schedule, as
    jax.tree.flatten gives them."""
    for cfg, n in ((dict(), 43), (dict(decay_steps=4, clip_norm=1.0), 44)):
        jp = _jparams(0, JFLAGSHIP)
        jst = jtrain.TrainConfig(**cfg).make_optimizer().init(jp)
        assert len(jax.tree.leaves({"params": jp, "opt_state": jst})) == n
        p = _port(jp)
        st = train.TrainConfig(**cfg).make_optimizer().init(p)
        path = str(tmp_path / f"c{n}.npz")
        ckpt.save_checkpoint(path, p, st, step=0)
        with np.load(path) as f:
            assert len(f.files) == n + 1
            assert f["leaf_0"].dtype == np.int32
            assert f["__step__"].dtype == np.int64


@pytest.mark.parametrize("cfg", SCHED, ids=["constant", "scheduled"])
def test_jax_checkpoint_resumes_in_port(tmp_path, rng, cfg):
    """A JAX checkpoint loads equal, and the port's next step from it
    matches JAX's next step within 1e-5."""
    jp, jst, jopt, _, _, _, batches = _trained(rng, cfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jp, jst, step=2)
    p = _port(_jparams(9))
    popt = train.TrainConfig(**cfg).make_optimizer()
    p, pst, step = ckpt.load_checkpoint(path, p, popt.init(p))
    assert step == 2 and pst.count == 2
    _close(p, jp, 0.0)
    x, y = batches[2]
    jp3, _, jl = jtrain.make_train_step(jopt)(jp, jst, jnp.asarray(x),
                                              jnp.asarray(y))
    p, _, pl_ = train.make_train_step(popt)(p, pst, x, y)
    assert abs(float(pl_) - float(jl)) <= 1e-6
    _close(p, jp3, 1e-5)


@pytest.mark.parametrize("cfg", SCHED, ids=["constant", "scheduled"])
def test_resume_is_bit_exact(tmp_path, rng, cfg):
    """2 steps, save, load into fresh state, 2 more == 4 straight steps, bit
    for bit on the CPU."""
    batches = [_batch(rng, 2) for _ in range(4)]
    jp = _jparams(5)

    def run(p, st, bs):
        step = train.make_train_step(st.optimizer)
        for x, y in bs:
            p, st, _ = step(p, st, x, y)
        return p, st

    opt = train.TrainConfig(**cfg).make_optimizer()
    p = _port(jp)
    straight, _ = run(p, opt.init(p), batches)
    p = _port(jp)
    p, st = run(p, opt.init(p), batches[:2])
    path = str(tmp_path / "mid.npz")
    ckpt.save_checkpoint(path, p, st, step=2)
    q = _port(_jparams(6))
    q, qst, step = ckpt.load_checkpoint(path, q, opt.init(q))
    q, _ = run(q, qst, batches[2:])
    for a, b in zip(train.leaves(q), train.leaves(straight)):
        assert torch.equal(a, b)


def test_checkpoint_rejects_another_state(tmp_path):
    p = _port(_jparams(0))
    st = train.Optimizer(1e-3).init(p)
    path = str(tmp_path / "a.npz")
    ckpt.save_checkpoint(path, p, st, step=1)
    sched = train.TrainConfig(decay_steps=3).make_optimizer()
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(path, p, sched.init(p))


# --- devices and precision -------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_the_card():
    jp = _jparams(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.trainable(params_from_numpy(jp))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(jp, [], train.TrainConfig())


def test_precision_flags():
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    for name, tf32 in (("highest", False), ("high", True), ("default", True),
                       (None, True)):
        with train.precision_flags(name):
            assert cudnn.allow_tf32 is tf32
        assert cudnn.allow_tf32 is before
    with pytest.raises(ValueError):
        with train.precision_flags("bf16"):
            pass


@pytest.mark.parametrize("precision,tf32", [("highest", False),
                                            ("default", True)])
def test_backward_runs_under_the_step_precision(rng, precision, tf32):
    """cuDNN reads its TF32 switch when each convolution runs, the
    backward's included (PyTorch's default for convolutions is TF32 on), so
    the step's backward must run inside the precision block: a gradient
    hook records the switch as the backward passes the first layer."""
    x, y = _batch(rng, 2)
    seen = []
    for sharded in (False, True):
        p = _port(_jparams(0))
        p[0]["w"].register_hook(
            lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        opt = train.Optimizer(1e-3)
        if sharded:
            from waifu2x_torch.parallel import mesh as m
            step = train.make_sharded_train_step(
                m.make_mesh((1, 2), ("dp", "sp"), ["cpu"] * 2), opt,
                precision)
        else:
            step = train.make_train_step(opt, precision)
        step(p, opt.init(p), x, y)
    assert seen and all(s is tf32 for s in seen)
