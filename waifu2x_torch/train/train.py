"""The training loop (the counterpart of the JAX package's train/train.py):
the successor of the reference's minibatch_adam.lua
(appendix/waifu2x-nocuda/lib/minibatch_adam.lua:5-60) and its settings
(settings.lua:21-32: lr 2.5e-4, crop 128, epoch 200).

Parameters are the port's tuple of {"w": HWIO, "b": [cout]} tensors
(models/weights.py, ops/convstack.py), their leaves autograd leaves
(`trainable`), and the step is `F.conv2d` under autograd with
`torch.optim.Adam`: the JAX package differentiates XLA's convolution, with
no Pallas kernel and no custom gradient on the training path, and so does
this module. The optimizer reproduces the optax chain TrainConfig builds
there: Adam (b1 0.9, b2 0.999, eps 1e-8), optax's cosine and warmup-cosine
schedules, optax's global-norm clipping.

`precision` maps to the card as follows (the JAX package's names):
  "highest"           f32 convolutions with TF32 off (the f32 reference);
  "high", "default"   TF32 convolutions (on a TPU "default" was one bf16
  and None            pass; the card's nearest is TF32).
On the CPU the three are the same f32 arithmetic. The choice covers the
backward pass too: cuDNN reads its TF32 switch when each convolution runs,
and PyTorch's default for convolutions is TF32 on, so the steps run the
loss and its backward() inside one precision_flags block.

make_sharded_train_step runs the step over a ("dp", "sp") mesh of
parallel/mesh.py: the batch split over "dp", each "sp" position the output
columns of its share and the input columns they read, the gradients summed
onto one set of leaves and, across processes, all-reduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from waifu2x_torch.ops.convstack import hwio_to_oihw, leaky_relu
from waifu2x_torch.parallel import mesh as w2x_mesh
from waifu2x_torch.parallel.multihost import _group
from waifu2x_torch.pipeline import resolve_device
from waifu2x_torch.utils.logging import get_logger

log = get_logger("train")

PRECISIONS = ("highest", "high", "default", None)


@contextlib.contextmanager
def precision_flags(precision: "str | None"):
    """cuDNN's TF32 switch for one precision name, inside this block only:
    off for "highest", on for "high", "default" and None."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic,
                     allow_tf32=precision != "highest"):
        yield


def layer(h: torch.Tensor, p) -> torch.Tensor:
    """One VALID 3x3 layer with its bias and LeakyReLU, NCHW."""
    return leaky_relu(F.conv2d(h, hwio_to_oihw(p["w"]).to(h.dtype),
                               p["b"].to(h.dtype)))


def stack_valid(x: torch.Tensor, params,
                precision: "str | None" = "highest") -> torch.Tensor:
    """The conv stack with VALID padding under `precision`, differentiable:
    x [N, H, W, 1] (NHWC, already padded by the model offset) ->
    [N, H - 2*offset, W - 2*offset, 1]. ops.convstack.conv_stack_valid is
    the same function with TF32 always off."""
    with precision_flags(precision):
        h = x.permute(0, 3, 1, 2)
        for p in params:
            h = layer(h, p)
    return h.permute(0, 2, 3, 1)


def trainable(params, device="cuda"):
    """A fresh copy of `params` (tensors or arrays) as f32 autograd leaves
    on `device`: what the optimizer and the train steps take. The caller's
    params are left as they are."""
    dev = resolve_device(device)
    return tuple({k: _tensor(v).detach().to(dev, torch.float32).clone()
                  .requires_grad_(True) for k, v in p.items()}
                 for p in params)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, np.float32))


def leaves(params) -> list:
    """The tensors of a params tuple in the JAX package's flatten order:
    each layer's "b", then its "w"."""
    return [p[k] for p in params for k in sorted(p)]


# --- schedules (optax's, as functions of the update count) ----------------

def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): a linear ramp from
    init_value to peak_value over warmup_steps, then the cosine decay to
    end_value; decay_steps counts the warmup too."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return cosine(count - warmup_steps)

    return schedule


# --- the optimizer ----------------------------------------------------------

def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: every gradient g becomes
    g / ||g|| * max_norm when the global norm ||g|| >= max_norm, and stays
    as it is below (torch.nn.utils.clip_grad_norm_ divides by ||g|| + 1e-6
    and is not the same function). The choice is made on the device, with
    no wait for the norm. Returns ||g||."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optax chain of the JAX package's TrainConfig.make_optimizer:
    [clip_by_global_norm(clip_norm)] -> adam(learning_rate), the rate a
    constant or a schedule of the update count. init(params) binds a
    torch.optim.Adam to the params' leaves."""

    learning_rate: "float | Callable[[int], float]"
    clip_norm: float = 0.0

    @property
    def scheduled(self) -> bool:
        return callable(self.learning_rate)

    def rate(self, count: int) -> float:
        """The rate of update `count` (0-based): optax reads its schedule at
        the count before the update increments it, so with warmup from 0
        the first update has rate 0."""
        return (self.learning_rate(count) if self.scheduled
                else self.learning_rate)

    def init(self, params) -> "OptState":
        adam = torch.optim.Adam(leaves(params), lr=self.rate(0),
                                betas=(0.9, 0.999), eps=1e-8)
        return OptState(self, params, adam)


@dataclasses.dataclass(eq=False)
class OptState:
    """Adam's state over one params tuple (the moments live in the
    torch.optim.Adam) and the update count that the schedule reads."""

    optimizer: Optimizer
    params: tuple
    adam: torch.optim.Adam
    count: int = 0

    def apply(self) -> None:
        """One update from the gradients on the leaves: clip, Adam at this
        count's rate, count + 1."""
        grads = [t.grad for t in leaves(self.params)]
        if self.optimizer.clip_norm > 0:
            clip_by_global_norm(grads, self.optimizer.clip_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.optimizer.rate(self.count)
        self.adam.step()
        self.count += 1

    def moments(self, leaf: torch.Tensor):
        """(first, second) moment of one leaf; zeros before any update."""
        st = self.adam.state.get(leaf, {})
        if "exp_avg" not in st:
            z = torch.zeros_like(leaf, memory_format=torch.preserve_format)
            return z, z.clone()
        return st["exp_avg"], st["exp_avg_sq"]

    def set_state(self, count: int, mu: list, nu: list) -> None:
        """Resume at update `count` with the leaves' moments (in leaves()
        order)."""
        for leaf, m, v in zip(leaves(self.params), mu, nu):
            self.adam.state[leaf] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(m).to(leaf).clone(),
                "exp_avg_sq": torch.as_tensor(v).to(leaf).clone()}
        self.count = int(count)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.00025   # settings.lua:28
    crop_size: int = 128             # settings.lua:29
    batch_size: int = 32             # minibatch_adam.lua:14 default
    epochs: int = 200                # settings.lua:31
    precision: "str | None" = "highest"
    # Optional cosine decay to `learning_rate * lr_min_ratio` over
    # `decay_steps` (0 = the reference's constant-lr Adam).
    decay_steps: int = 0
    lr_min_ratio: float = 0.05
    # Optional linear lr warmup from 0 (0 = none). Only meaningful with
    # decay.
    warmup_steps: int = 0
    # Optional exponential moving average of the params (0 = off).
    ema_decay: float = 0.0
    # Optional global-norm gradient clipping (0 = off).
    clip_norm: float = 0.0

    def make_optimizer(self) -> Optimizer:
        lr = self.learning_rate
        if self.decay_steps > 0:
            if self.warmup_steps > 0:
                lr = warmup_cosine_decay_schedule(
                    0.0, self.learning_rate, self.warmup_steps,
                    self.decay_steps, self.learning_rate * self.lr_min_ratio)
            else:
                lr = cosine_decay_schedule(self.learning_rate,
                                           self.decay_steps,
                                           self.lr_min_ratio)
        return Optimizer(lr, self.clip_norm)


# --- losses and steps -------------------------------------------------------

def loss_fn(params, x: torch.Tensor, y: torch.Tensor,
            precision: "str | None" = "highest") -> torch.Tensor:
    """MSE criterion on the valid output region (the Lua trainer's
    nn.MSECriterion over the offset-cropped target)."""
    pred = stack_valid(x, params, precision)
    return torch.mean((pred - y) ** 2)


def _device_of(params) -> torch.device:
    return params[0]["w"].device


def _on(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(t).to(dev, torch.float32)


def make_train_step(optimizer: Optimizer,
                    precision: "str | None" = "highest",
                    loss: "Callable | None" = None) -> Callable:
    """step(params, opt_state, x, y) -> (params, opt_state, loss): one
    update of the leaves (in place; opt_state = optimizer.init(params))
    from the batch x [N, H, W, 1], y [N, H - 2*offset, W - 2*offset, 1]
    (arrays or tensors, moved to the params' device). The loss comes back
    as a device scalar. `loss(params, x, y, precision)` defaults to the MSE
    criterion; QAT finetunes pass their own (train/qat.py)."""
    _loss = loss or loss_fn

    def train_step(params, opt_state: OptState, x, y):
        dev = _device_of(params)
        opt_state.adam.zero_grad(set_to_none=True)
        # the backward's convolutions read cuDNN's TF32 switch when they
        # run, so the precision covers them too
        with precision_flags(precision):
            value = _loss(params, _on(x, dev), _on(y, dev), precision)
            value.backward()
        opt_state.apply()
        return params, opt_state, value.detach()

    return train_step


def column_split(width: int, parts: int) -> list:
    """[(c0, c1)] of `parts` output-column shares of `width`, as even as the
    width allows (18 over 4: 4, 5, 4, 5); a share may be empty."""
    cuts = [width * j // parts for j in range(parts + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def make_sharded_train_step(mesh: w2x_mesh.Mesh, optimizer: Optimizer,
                            precision: "str | None" = "highest",
                            loss: "Callable | None" = None) -> Callable:
    """The train step over a ("dp", "sp") mesh (parallel/mesh.py, the
    layout parallel/multihost.global_mesh builds); the JAX package's is
    GSPMD's partition of the jitted step.

    step(params, opt_state, x, y) as make_train_step's, with the leaves on
    the first device of this process's positions and x, y the samples of
    the "dp" rows that this process's positions hold, in order (one
    process: the whole batch). The batch splits over "dp"; the output
    columns split over "sp" (unevenly where they must: 18 over 4), and each
    position reads its output columns' input columns, its own and the
    2 * offset to their right (a training crop is already padded and runs
    VALID, so there is no edge to replicate: parallel/mesh.halo's is an
    inference plane's). Each position reads the params through
    mesh.to_device (what mesh.replicate does for each device: on the
    leaves' own device the leaves themselves, elsewhere a differentiable
    copy of its own), and its loss, weighted by its share of the output
    elements, is differentiated at once, so the gradients of every
    position sum onto the leaves and no position's activations outlive its
    turn. Across processes the gradients and the loss are all-reduced
    (torch.distributed: gloo on the CPU, NCCL on cards), and each process's
    Adam then takes the same update, so the params stay replicated.

    So a custom `loss` must be a mean of per-pixel terms. A loss with a
    per-sample statistic (make_qat_l6_loss's activation scale, a maximum
    over the whole sample) carries `l6_absmax(params, x, precision)`: a
    no-grad pass gives each position's per-sample maxima, they are reduced
    over "sp" (and across processes), and the differentiated pass gets the
    result as `absmax=`."""
    _loss = loss or loss_fn
    positions = mesh.local_positions()
    rows = sorted({pos[0] for pos in positions})
    dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")

    def ctx(dev):
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def train_step(params, opt_state: OptState, x, y):
        world, _ = _group()
        first = _device_of(params)
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        nb, rem = divmod(x.shape[0], len(rows))
        if rem or y.shape[0] != x.shape[0]:
            raise ValueError(f"batch {x.shape[0]} over this process's "
                             f"{len(rows)} dp rows")
        n, wo = nb * dp, y.shape[2]
        halo = x.shape[2] - wo
        cols = column_split(wo, sp)

        def block(pos):
            """The position's device, params (a differentiable copy, or the
            leaves themselves on their own device) and x, y blocks."""
            i, j = pos
            r = rows.index(i) * nb
            c0, c1 = cols[j]
            dev = mesh.device(pos)
            return (dev, w2x_mesh.to_device(params, dev),
                    _on(x[r:r + nb, :, c0:c1 + halo], dev),
                    _on(y[r:r + nb, :, c0:c1], dev))

        absmax = None
        if hasattr(_loss, "l6_absmax"):
            absmax = torch.zeros(n, device=first)
            with torch.no_grad():
                for pos in positions:
                    if cols[pos[1]][1] > cols[pos[1]][0]:
                        dev, p_dev, xb, _ = block(pos)
                        with ctx(dev):
                            m = _loss.l6_absmax(p_dev, xb, precision)
                        s = slice(pos[0] * nb, (pos[0] + 1) * nb)
                        absmax[s] = torch.maximum(absmax[s], m.to(first))
            if world > 1:
                dist.all_reduce(absmax, op=dist.ReduceOp.MAX)

        opt_state.adam.zero_grad(set_to_none=True)
        total = torch.zeros((), device=first)
        for pos in positions:
            c0, c1 = cols[pos[1]]
            if c1 <= c0:
                continue
            dev, p_dev, xb, yb = block(pos)
            kw = {} if absmax is None else {
                "absmax": absmax[pos[0] * nb:(pos[0] + 1) * nb].to(dev)}
            with ctx(dev), precision_flags(precision):
                part = _loss(p_dev, xb, yb, precision, **kw) * (
                    nb * (c1 - c0) / (n * wo))
                part.backward()
            total += part.detach().to(first)
        if world > 1:
            for t in leaves(params):
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
                dist.all_reduce(t.grad)
            dist.all_reduce(total)
        opt_state.apply()
        return params, opt_state, total

    return train_step


def train_loop(params, batches: Iterable, cfg: TrainConfig = TrainConfig(),
               mesh: "w2x_mesh.Mesh | None" = None, log_every: int = 50,
               eval_every: int = 0, eval_fn: "Callable | None" = None,
               loss: "Callable | None" = None, device="cuda"):
    """Run Adam over an iterable of (x, y) NHWC batches from a copy of
    `params` on `device` (with a mesh: its first position's device);
    returns (params, losses), or (params, losses, ema_params) when
    cfg.ema_decay > 0. Replaces minibatch_adam's feval/optim.adam loop.

    eval_fn(step, params, ema_params_or_None) is called every `eval_every`
    steps and once at the end. The EMA starts from the initial params and
    is updated after every step.

    Losses stay device scalars and are fetched every `log_every` steps (and
    before each eval): a per-step fetch would wait for every step."""
    if mesh is not None:
        device = mesh.device(mesh.local_positions()[0])
    params = trainable(params, device)
    optimizer = cfg.make_optimizer()
    opt_state = optimizer.init(params)
    step = (make_sharded_train_step(mesh, optimizer, cfg.precision, loss)
            if mesh is not None
            else make_train_step(optimizer, cfg.precision, loss))
    ema = None
    if cfg.ema_decay > 0.0:
        d = cfg.ema_decay
        ema = tuple({k: v.detach().clone() for k, v in p.items()}
                    for p in params)
    losses: list = []
    pending: list = []

    def drain():
        if pending:
            losses.extend(torch.stack(pending).cpu().tolist())
            pending.clear()

    last_eval = -1
    for i, (x, y) in enumerate(batches):
        params, opt_state, value = step(params, opt_state, x, y)
        if ema is not None:
            with torch.no_grad():
                for e, p in zip(leaves(ema), leaves(params)):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        pending.append(value)
        if (i + 1) % log_every == 0:
            drain()
            log.info("step %d  mse %.6f", i + 1,
                     np.mean(losses[-log_every:]))
        if eval_fn is not None and eval_every > 0 and (i + 1) % eval_every == 0:
            drain()
            eval_fn(i + 1, params, ema)
            last_eval = i + 1
    drain()
    if eval_fn is not None and len(losses) != last_eval:
        eval_fn(len(losses), params, ema)
    if ema is not None:
        return params, losses, ema
    return params, losses
