"""Training harness: the guarded optimizer chain, training segments, epoch-fresh
data, the wall-clock budget and best-loss checkpointing (port of
``training/train.py``).

Rebuild of reference train_utils.train_model (:159-492):
- per-epoch fresh dataset (expert replay or synthetic regeneration,
  :353-370)
- minibatch loop, loss = MSE(model(s0, a0, ts), sn - s0) (:388-408)
- Adam + global-norm grad clip 0.1 (:297-301, :406), optional StepLR
- best-loss checkpointing every iters_per_log (:440-448)
- wall-clock cutoff (:415-425), with set-up work excluded from the budget
- reject-don't-clip guard (beyond reference): a non-finite or exploding
  batch (Config.training_loss_skip_factor x the previous segment's median)
  leaves the params and the Adam state untouched

The optimizer is the JAX package's optax chain written as a functional
optimizer over the parameter tree: ``make_optimizer(config).update(grads,
state, params)`` returns the updates and a new ``AdamState`` (count, mu,
nu), so a state can be kept or restored whole. A segment is a Python loop
of autograd steps where the JAX module scans one jitted step; the guard is
a ``torch.where`` on the device, so the loop never waits for it. Training
differentiates the plain model (``model.apply``): the fused kernel is
forward-only, in the JAX package too.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, NamedTuple, Optional

import torch

from ..config import Config
from ..envs import make_env
from ..models import DynamicsModel, count_params, make_model
from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..utils.checkpoint import checkpoint_read_path, load_pytree, model_checkpoint_name, save_pytree
from ..utils.device import resolve_device
from ..utils.timing import Timer

logger = logging.getLogger(__name__)

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
_INT32_MAX = 2**31 - 1


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count (int32) and the first
    and second moments as trees shaped like the params."""

    count: torch.Tensor
    mu: dict
    nu: dict


class Optimizer(NamedTuple):
    """``init(params) -> AdamState`` and ``update(grads, state, params) ->
    (updates, state)``, the interface of an optax ``GradientTransformation``."""

    init: Callable
    update: Callable


def make_optimizer(config: Config) -> Optimizer:
    """The JAX package's chain, in order: zero every non-finite gradient
    element (NaN, +Inf, -Inf); ``clip_by_global_norm(config.clip_grad_norm)``
    (``g`` when ||g|| < max, else ``g / ||g|| * max``); add
    ``weight_decay * params`` when set; Adam (b1 0.9, b2 0.999, eps 1e-8
    outside the square root of the bias-corrected second moment); scale by
    ``-learning_rate``, under ``use_lr_scheduler`` by
    ``exponential_decay(..., staircase=True)`` of Adam's count."""
    max_norm = config.clip_grad_norm
    wd = config.weight_decay
    lr0 = config.learning_rate

    def learning_rate(count: torch.Tensor, dtype) -> torch.Tensor:
        if not config.use_lr_scheduler:
            return torch.tensor(lr0, dtype=dtype, device=count.device)
        # optax's exponential_decay divides the int32 count, which JAX
        # promotes to float32: the schedule is float32 at any param dtype
        f32 = dict(dtype=torch.float32, device=count.device)
        p = torch.floor(count.to(torch.float32) / config.lr_scheduler_step_size)
        decayed = torch.tensor(lr0, **f32) * torch.pow(torch.tensor(config.lr_scheduler_gamma, **f32), p)
        return torch.where(count <= 0, torch.tensor(lr0, **f32), decayed).to(dtype)

    def update(grads, state: AdamState, params=None):
        g = [torch.where(torch.isfinite(x), x, torch.zeros_like(x)) for x in tree_leaves(grads)]
        if wd and params is None:
            raise ValueError("weight_decay needs the params")
        g_norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = g_norm < max_norm
        g = [torch.where(keep, x, (x / g_norm) * max_norm) for x in g]
        if wd:
            g = [x + wd * p for x, p in zip(g, tree_leaves(params))]
        return _adam(grads, g, state, learning_rate(state.count, g[0].dtype))

    return Optimizer(init=_adam_init, update=update)


def _adam_init(params) -> AdamState:
    zeros = [torch.zeros_like(x) for x in tree_leaves(params)]
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=zeros[0].device),
        mu=tree_unflatten(params, zeros),
        nu=tree_unflatten(params, [z.clone() for z in zeros]),
    )


def _adam(grads, g: list, state: AdamState, lr: torch.Tensor):
    """Adam on the gradient leaves ``g`` (the tree of ``grads``), scaled by -lr."""
    mu = [(1 - _ADAM_B1) * x + _ADAM_B1 * m for x, m in zip(g, tree_leaves(state.mu))]
    nu = [(1 - _ADAM_B2) * (x * x) + _ADAM_B2 * v for x, v in zip(g, tree_leaves(state.nu))]
    count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
    dtype = g[0].dtype
    c = count.to(dtype)
    bc1 = 1 - torch.pow(torch.tensor(_ADAM_B1, dtype=dtype, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(_ADAM_B2, dtype=dtype, device=c.device), c)
    updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS)) for m, v in zip(mu, nu)]
    return tree_unflatten(grads, updates), AdamState(
        count=count, mu=tree_unflatten(state.mu, mu), nu=tree_unflatten(state.nu, nu))


def make_adam(learning_rate: float) -> Optimizer:
    """``optax.adam(learning_rate)`` alone: Adam (b1 0.9, b2 0.999, eps 1e-8)
    scaled by ``-learning_rate``, with no clip and no guard, the optimizer of
    the JAX package's ODE-RL trainers."""

    def update(grads, state: AdamState, params=None):
        g = tree_leaves(grads)
        return _adam(grads, g, state, torch.tensor(learning_rate, dtype=g[0].dtype, device=g[0].device))

    return Optimizer(init=_adam_init, update=update)


def make_train_segment_fn(model: DynamicsModel, optimizer: Optimizer):
    """One training segment: the update step over a [S, bs] block of batch
    indices (S = iters_per_log batches, the reference's logging and
    checkpoint cadence at train_utils.py:410-448).

    ``segment_fn(params, opt_state, s0, a0, sn, ts, batch_idx, loss_cap=inf)
    -> (params, opt_state, losses [S])``. A batch whose loss is non-finite
    or above ``loss_cap`` leaves the params and every field of the state
    bit-for-bit as they were; its loss is still reported.
    """

    def segment_fn(params, opt_state: AdamState, s0, a0, sn, ts, batch_idx, loss_cap=math.inf):
        params = tree_map(torch.Tensor.detach, params)
        losses = []
        for idx in batch_idx:
            leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
            pred = model.apply(tree_unflatten(params, leaves), s0[idx], a0[idx], ts[idx])
            target = sn[idx] - s0[idx]
            loss = torch.mean((torch.squeeze(pred) - torch.squeeze(target)) ** 2)
            # a leaf the forward never reads (latent_ode_ref's gen-ODE net)
            # gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                loss = loss.detach()
                updates, new = optimizer.update(tree_unflatten(params, grads), opt_state, params)
                # reject-don't-clip: a non-finite or exploding batch moves
                # neither the params nor the Adam state
                ok = torch.isfinite(loss) & (loss <= loss_cap)

                def keep(a, b):
                    return torch.where(ok, a, b)

                params = tree_map(lambda x, u: keep((x + u).to(x.dtype), x), params, updates)
                opt_state = AdamState(count=keep(new.count, opt_state.count),
                                      mu=tree_map(keep, new.mu, opt_state.mu),
                                      nu=tree_map(keep, new.nu, opt_state.nu))
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return segment_fn


def median(x: torch.Tensor) -> float:
    """``jnp.median`` of a 1-d tensor: NaN if any element is NaN, else the
    middle value, or for an even count the two middle values' sum times 0.5
    in the tensor's dtype (``torch.median`` returns the lower one)."""
    x = x.detach().cpu()
    if bool(torch.isnan(x).any()):
        return math.nan
    s = torch.sort(x).values
    n = s.shape[0]
    return float((s[(n - 1) // 2] + s[n // 2]) * 0.5)


def get_epoch_data(env, env_name, delay, config: Config, data_seed: int, dtype=torch.float32, device="cuda"):
    """One epoch's (s0, a0, sn, ts) in ``dtype``: the expert buffer
    (``collect_expert_data`` and its cache) or a fresh synthetic dataset
    drawn from ``SyntheticDraws(data_seed)``."""
    # local import: data.collector itself builds on training.rollout
    from ..data import SyntheticDraws, collect_expert_data, generate_irregular_data_delay_time_multi

    if config.train_with_expert_trajectories:
        data = collect_expert_data(env_name, delay, config=config, dtype=dtype, device=device)
        return tuple(x.to(dtype) for x in data)
    return generate_irregular_data_delay_time_multi(
        env,
        SyntheticDraws(data_seed, dtype=dtype, device=device),
        delay=delay,
        samples_per_dim=config.train_samples_per_dim,
        rand=config.rand_sample,
        action_buffer_size=config.action_buffer_size,
        encode_obs_time=config.encode_obs_time,
        reuse_state_actions_when_sampling_times=config.reuse_state_actions_when_sampling_times,
    )


def train_model(
    model_name: str,
    env_name: str,
    config: Config = Config(),
    delay: int = 0,
    retrain: bool = False,
    force_retrain: bool = False,
    model_seed: int = 0,
    start_from_checkpoint: bool = True,
    end_training_after_seconds: Optional[float] = None,
    dtype=torch.float32,
    device="cuda",
):
    """Train (or load) a dynamics model. Returns (model, params, results).

    The init draws from a ``torch.Generator`` seeded with ``model_seed``, the
    epoch data, the sample subset and the batch order from one seeded with
    ``model_seed + 10_000``: the streams are the port's own, not JAX's.
    ``node`` trains at batch size 1, and ``latent_ode`` through
    ``training.train_latent_ode`` (its own loss, no guard), as in the JAX
    package; ``latent_ode_ref`` trains through the generic segments, as it
    does there (its gen-ODE net is never evaluated and keeps its values).
    """
    device = resolve_device(device)
    ckpt_name = model_checkpoint_name(
        model_name,
        env_name,
        delay,
        config.ts_grid,
        model_seed,
        config.train_with_expert_trajectories,
        training_epochs=None if config.end_training_after_seconds else config.training_epochs,
        samples_used=config.training_use_only_samples,
    )
    ckpt_path = os.path.join(config.saved_models_path, ckpt_name)
    ckpt_read_path = checkpoint_read_path(ckpt_name, config, retrain, force_retrain)

    env = make_env(env_name, ts_grid=config.ts_grid, dt=config.dt * config.train_dt_multiple)
    spec = env.spec
    model = make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, config,
                       dtype=dtype, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(model_seed))
    n_params = count_params(params)
    logger.info("[%s %s d=%d] params=%d", env_name, model_name, delay, n_params)

    if not force_retrain:
        if not retrain and os.path.isfile(ckpt_read_path):
            return model, load_pytree(ckpt_read_path, like=params), {"total_reward": None}
        if not retrain:
            raise ValueError(f"No checkpoint at {ckpt_path} and retrain=False")
        # warm-start only from the working dir, never the tracked fallback
        if start_from_checkpoint and os.path.isfile(ckpt_path):
            params = load_pytree(ckpt_path, like=params)

    if model_name == "latent_ode":
        from .train_latent_ode import train_latent_ode

        # the caller's budget override goes along
        return train_latent_ode(model, params, env, env_name, config, delay, ckpt_path,
                                end_training_after_seconds=end_training_after_seconds, dtype=dtype,
                                device=device)

    optimizer = make_optimizer(config)
    opt_state = optimizer.init(params)
    segment_fn = make_train_segment_fn(model, optimizer)
    batch_size_cfg = 1 if model_name == "node" else config.training_batch_size  # the JAX training/train.py:244

    budget = (
        end_training_after_seconds
        if end_training_after_seconds is not None
        else config.end_training_after_seconds
    )
    timer = Timer()
    best_loss = float("inf")
    last_loss = float("nan")
    # reject-don't-clip cap for exploding batches; the first segment runs
    # unguarded (untrained models legitimately start at pole-scale losses)
    loss_cap = float("inf")
    data_gen = torch.Generator().manual_seed(model_seed + 10_000)
    epoch_losses = []
    segment_curve = []  # [updates at the segment's end, its mean loss]
    seen_shapes = set()
    stop = False
    total_iters = 0
    next_eval = config.iters_per_evaluation
    eval_rewards = []

    for epoch_i in range(config.training_epochs):
        # the budget also guards the epoch loop: tiny datasets can yield zero
        # full batches, and then the per-segment cutoff below never runs
        if budget is not None and timer.elapsed() > budget:
            break
        data_seed = int(torch.randint(0, 2**62, (1,), generator=data_gen))
        with timer.exclude():  # dataset build/load is outside the budget
            s0, a0, sn, ts = get_epoch_data(env, env_name, delay, config, data_seed, dtype, device)
            if config.training_use_only_samples is not None:
                # a random N-subset like the reference (train_utils.py:
                # 340-344 randperm[:N]): expert data is episode-ordered
                idx = torch.randperm(s0.shape[0], generator=data_gen)[: config.training_use_only_samples]
                idx = idx.to(device)
                s0, a0, sn, ts = s0[idx], a0[idx], sn[idx], ts[idx]
        n = s0.shape[0]
        batch_size = min(batch_size_cfg, n)
        perm = torch.randperm(n, generator=data_gen)
        n_batches = n // batch_size
        seg_len = max(1, min(config.iters_per_log, n_batches))
        n_segments = n_batches // seg_len
        batches = perm[: n_segments * seg_len * batch_size].reshape(n_segments, seg_len, batch_size).to(device)

        seg_losses = []
        for seg_i in range(n_segments):
            shape_key = (seg_len, batch_size, n)
            if shape_key not in seen_shapes:
                # the first segment of a new shape is set-up (the JAX
                # package's jit compile), outside the budget
                with timer.exclude():
                    params, opt_state, losses = segment_fn(
                        params, opt_state, s0, a0, sn, ts, batches[seg_i], loss_cap)
                    losses = losses.cpu()
                seen_shapes.add(shape_key)
            else:
                params, opt_state, losses = segment_fn(
                    params, opt_state, s0, a0, sn, ts, batches[seg_i], loss_cap)
                losses = losses.cpu()
            track_loss = float(torch.mean(losses))
            last_loss = float(losses[-1])
            seg_losses.append(track_loss)
            if config.training_loss_skip_factor:
                # the median is robust to the very spikes the cap rejects
                seg_median = median(losses)
                if math.isfinite(seg_median) and seg_median > 0:
                    loss_cap = config.training_loss_skip_factor * seg_median
            elapsed = timer.elapsed()
            logger.info(
                "[%s %s d=%d][epoch=%04d|seg=%03d/%03d|t=%.0f/%s] train_loss=%g",
                env_name, model_name, delay, epoch_i + 1, seg_i + 1, n_segments,
                elapsed, budget, track_loss,
            )
            # best-loss checkpointing per log window (train_utils.py:440-443)
            if track_loss < best_loss:
                best_loss = track_loss
                with timer.exclude():
                    save_pytree(ckpt_path, params)
            # mid-training policy evaluation every iters_per_evaluation
            # updates (train_utils.py:450-459; the default never fires),
            # outside the budget
            total_iters += seg_len
            segment_curve.append([total_iters, track_loss])
            if total_iters >= next_eval:
                next_eval += config.iters_per_evaluation
                with timer.exclude():
                    from .eval import evaluate_policy

                    r = evaluate_policy(
                        model_name, env_name, delay, seeds=[0], config=config,
                        model_apply=model.apply, params=params, dtype=dtype, device=device,
                    )
                eval_rewards.append(r["total_reward"])
                logger.info(
                    "[%s %s d=%d] mid-train eval total_reward=%.1f",
                    env_name, model_name, delay, r["total_reward"],
                )
            if budget is not None and elapsed > budget:
                logger.info("[%s %s d=%d] Ending training (budget)", env_name, model_name, delay)
                stop = True
                break
        epoch_losses.append(sum(seg_losses) / max(len(seg_losses), 1))
        if stop:
            break

    save_pytree(ckpt_path, params)
    results = {
        "train_loss": last_loss,
        "best_val_loss": best_loss,
        "epoch_losses": epoch_losses,
        "segment_losses": segment_curve,
        "n_params": n_params,
        "total_reward": eval_rewards[-1] if eval_rewards else None,
        "eval_rewards": eval_rewards,
        "train_seconds": timer.elapsed(),
    }
    return model, params, results
