"""Delay-ensemble training (port of ``training/ensemble.py``): one model family
trained on several action delays at once, the per-delay parameter trees
stacked on a leading delay axis.

The reference trains the grid's delay axis one cell at a time
(run_exp_multi.py:103-132). These dynamics models are small (<100k params,
batch 16), so one device stepping one model is bound by its launches; here
one update steps every delay: ``torch.func.vmap`` over ``torch.func.grad``
and over the optimizer's update, the counterpart of the JAX module's
``jax.vmap`` of its jitted step.

Semantics per delay are those of ``training.train.train_model``: the loss
MSE(model(s0, a0, ts), sn - s0), the optimizer chain with its global-norm
clip taken over each delay's own gradients, the same streams (the init from
``model_seed``, the epoch data, sample subset and batch order from
``model_seed + 10_000``), the same per-segment best-loss checkpoints under
the same per-delay names. The batch indices are shared across delays; each
delay's epoch data is cut to the rows that every delay has. So a 1-delay
ensemble reproduces ``train_model``'s trajectory while ``train_model``'s
guard does not fire. Where the JAX module differs from ``train_model`` this
module follows it:

- no reject-don't-clip guard: every update is applied, a non-finite loss
  included (its gradients are zeroed by the chain);
- ``node`` trains at the configured batch size, not at batch 1;
- the latent ODE takes one stream of IWAE draws per delay: delay i's draws
  come from a generator seeded with ``1 + i`` (delay 0's is
  ``train_latent_ode``'s), and the segment takes them as an argument.

Members do not interact: the stacked update equals the per-delay updates,
which the tests hold at f64. As the JAX module records, this is equivalence
of semantics, not of numbers: in f32 the batched products round in another
order, and over many updates the ensemble walks another trajectory, like
another draw. For the NL flagship one such draw (pendulum, delay 3) kept the
train MSE and lost the swing-up, so the driver trains NL per delay by
default (``--ensemble_exclude nl``) and can gate ensemble output with a
control evaluation (``--ensemble_gate``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
from torch.func import grad_and_value, vmap

from ..config import Config
from ..envs import make_env
from ..models import count_params, make_model
from ..models.common import tree_map
from ..utils.checkpoint import load_pytree, model_checkpoint_name, save_pytree
from ..utils.device import resolve_device
from ..utils.timing import Timer
from .train import AdamState, Optimizer, get_epoch_data, make_optimizer
from .train_latent_ode import _IWAE_SAMPLES, build_history_windows

logger = logging.getLogger(__name__)


def stack_trees(trees):
    """Parameter trees of one structure -> one tree, each leaf stacked on a
    new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def slice_tree(tree, i: int):
    """Member ``i`` of a stacked tree."""
    return tree_map(lambda x: x[i], tree)


def stack_states(states) -> AdamState:
    """Per-member ``AdamState``s -> one, each field stacked on a leading axis."""
    return AdamState(count=torch.stack([s.count for s in states]), mu=stack_trees([s.mu for s in states]),
                     nu=stack_trees([s.nu for s in states]))


def _stacked_update(loss_fn, optimizer: Optimizer, in_dims):
    """``update(params, opt_state, *args) -> (params, opt_state, loss)`` over
    the members: each member's gradient of ``loss_fn(p, *args)`` through the
    optimizer chain, as ``jax.vmap`` of the JAX module's update step.
    ``in_dims`` gives the args' member axes (None: shared)."""

    def member(params, opt_state, *args):
        grads, loss = grad_and_value(loss_fn)(params, *args)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tree_map(lambda x, u: (x + u).to(x.dtype), params, updates), opt_state, loss

    return vmap(member, in_dims=(0, 0) + tuple(in_dims))


def make_ensemble_segment_fn(model_apply, optimizer: Optimizer):
    """One training segment of every member: ``segment_fn(params, opt_state,
    s0, a0, sn, ts, batch_idx) -> (params, opt_state, losses [D, S])``.
    params, opt_state and the data carry the leading delay axis D;
    ``batch_idx`` [S, bs] is shared. Every update is applied."""

    def loss_fn(p, s0, a0, sn, ts, idx):
        pred = model_apply(p, s0[idx], a0[idx], ts[idx])
        return torch.mean((torch.squeeze(pred) - torch.squeeze(sn[idx] - s0[idx])) ** 2)

    update = _stacked_update(loss_fn, optimizer, (0, 0, 0, 0, None))

    def segment_fn(params, opt_state: AdamState, s0, a0, sn, ts, batch_idx):
        params = tree_map(torch.Tensor.detach, params)
        losses = []
        for idx in batch_idx:
            params, opt_state, loss = update(params, opt_state, s0, a0, sn, ts, idx)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses, dim=1)

    return segment_fn


def make_latent_ode_ensemble_segment_fn(model, optimizer: Optimizer):
    """The latent ODE's segment of every member: ``segment_fn(params,
    opt_state, eps, hist_s, hist_a, target, ts, batch_idx) -> (params,
    opt_state, losses [D, U])``, update u of member i drawing z0's noise from
    ``eps[i, u]`` [3, bs, latents]."""

    def loss_fn(p, eps, hist_s, hist_a, target, ts, idx):
        return model.train_step(p, eps, hist_s[idx], hist_a[idx], ts[idx], target[idx])

    update = _stacked_update(loss_fn, optimizer, (0, 0, 0, 0, 0, None))

    def segment_fn(params, opt_state: AdamState, eps, hist_s, hist_a, target, ts, batch_idx):
        params = tree_map(torch.Tensor.detach, params)
        losses = []
        for u, idx in enumerate(batch_idx):
            params, opt_state, loss = update(params, opt_state, eps[:, u], hist_s, hist_a, target, ts, idx)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses, dim=1)

    return segment_fn


def train_model_ensemble(
    model_name: str,
    env_name: str,
    config: Config = Config(),
    delays: Sequence[int] = (0, 1, 2, 3),
    retrain: bool = True,
    force_retrain: bool = False,
    model_seed: int = 0,
    start_from_checkpoint: bool = True,
    end_training_after_seconds: Optional[float] = None,
    dtype=torch.float32,
    device="cuda",
) -> dict:
    """Train one model family on all ``delays`` at once.

    Returns {delay: (model, params, results)}. The checkpoints land under the
    names ``train_model`` uses, so ``evaluate_policy`` and
    ``train_model(retrain=False)`` load them as they are. ``retrain`` is
    accepted for the JAX signature: the ensemble always trains, warm-started
    from each delay's checkpoint in ``saved_models_path`` unless
    ``force_retrain`` or not ``start_from_checkpoint``.
    """
    del retrain
    device = resolve_device(device)
    delays = list(delays)
    env = make_env(env_name, ts_grid=config.ts_grid, dt=config.dt * config.train_dt_multiple)
    spec = env.spec
    model = make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, config, dtype=dtype,
                       device=device)
    ckpt_paths = {
        d: os.path.join(
            config.saved_models_path,
            model_checkpoint_name(
                model_name, env_name, d, config.ts_grid, model_seed, config.train_with_expert_trajectories,
                training_epochs=None if config.end_training_after_seconds else config.training_epochs,
                samples_used=config.training_use_only_samples,
            ),
        )
        for d in delays
    }

    # the same init for every delay: the reference's per-cell seed_all(seed)
    params0 = model.init(torch.Generator(device=device).manual_seed(model_seed))
    per_delay_params = []
    for d in delays:
        p = params0
        if not force_retrain and start_from_checkpoint and os.path.isfile(ckpt_paths[d]):
            p = load_pytree(ckpt_paths[d], like=params0)
        per_delay_params.append(p)
    params_e = stack_trees(per_delay_params)
    logger.info("[%s %s delays=%s] ensemble params=%d x %d delays", env_name, model_name, delays,
                count_params(params0), len(delays))

    optimizer = make_optimizer(config)
    opt_state_e = stack_states([optimizer.init(p) for p in per_delay_params])
    is_latent = model_name == "latent_ode"
    batch_size = config.training_batch_size
    if is_latent:
        segment_fn = make_latent_ode_ensemble_segment_fn(model, optimizer)
        data_gen = torch.Generator().manual_seed(1)  # train_latent_ode's streams
        noise_gens = [torch.Generator(device=device).manual_seed(1 + i) for i in range(len(delays))]
    else:
        segment_fn = make_ensemble_segment_fn(model.apply, optimizer)
        data_gen = torch.Generator().manual_seed(model_seed + 10_000)  # train_model's stream

    budget = end_training_after_seconds if end_training_after_seconds is not None else config.end_training_after_seconds
    timer = Timer()
    D = len(delays)
    best_loss = [float("inf")] * D
    last_loss = [float("nan")] * D
    epoch_losses = []
    seen_shapes = set()
    stop = False

    for epoch_i in range(config.training_epochs):
        if budget is not None and timer.elapsed() > budget:
            break
        data_seed = int(torch.randint(0, 2**62, (1,), generator=data_gen))
        with timer.exclude():  # dataset build and load outside the budget
            per_delay = [get_epoch_data(env, env_name, d, config, data_seed, dtype, device) for d in delays]
            n_min = min(x[0].shape[0] for x in per_delay)
            per_delay = [tuple(arr[:n_min] for arr in x) for x in per_delay]
            if config.training_use_only_samples is not None:
                idx = torch.randperm(n_min, generator=data_gen)[: config.training_use_only_samples].to(device)
                per_delay = [tuple(arr[idx] for arr in x) for x in per_delay]
                n_min = min(config.training_use_only_samples, n_min)
            if is_latent:
                per_delay = [build_history_windows(*x, config.action_buffer_size) for x in per_delay]
                n_min = per_delay[0][0].shape[0]
            data_e = tuple(torch.stack([x[i] for x in per_delay]) for i in range(len(per_delay[0])))
        batch_size_eff = min(batch_size, n_min)
        perm = torch.randperm(n_min, generator=data_gen)
        n_batches = n_min // batch_size_eff
        seg_len = max(1, min(config.iters_per_log, n_batches))
        n_segments = n_batches // seg_len
        batches = perm[: n_segments * seg_len * batch_size_eff].reshape(n_segments, seg_len, batch_size_eff)
        batches = batches.to(device)

        seg_losses = []
        for seg_i in range(n_segments):
            args = (params_e, opt_state_e)
            if is_latent:
                # fresh IWAE draws for every segment, one stream per delay
                eps = torch.stack([
                    torch.randn((seg_len, _IWAE_SAMPLES, batch_size_eff, model.latents), generator=g, dtype=dtype,
                                device=device)
                    for g in noise_gens])
                args += (eps,)
            args += data_e + (batches[seg_i],)
            shape_key = (seg_len, batch_size_eff, n_min)
            if shape_key not in seen_shapes:
                with timer.exclude():  # the first segment of a shape is set-up
                    params_e, opt_state_e, losses = segment_fn(*args)
                    losses = losses.cpu()
                seen_shapes.add(shape_key)
            else:
                params_e, opt_state_e, losses = segment_fn(*args)
                losses = losses.cpu()
            mean_losses = [float(x) for x in torch.mean(losses, dim=1)]
            seg_losses.append(mean_losses)
            last_loss = [float(x) for x in losses[:, -1]]
            elapsed = timer.elapsed()
            logger.info("[%s %s delays=%s][epoch=%04d|seg=%03d/%03d|t=%.0f/%s] train_loss=%s", env_name,
                        model_name, delays, epoch_i + 1, seg_i + 1, n_segments, elapsed, budget,
                        "/".join(f"{x:g}" for x in mean_losses))
            with timer.exclude():
                for i, d in enumerate(delays):
                    if mean_losses[i] < best_loss[i]:
                        best_loss[i] = mean_losses[i]
                        save_pytree(ckpt_paths[d], slice_tree(params_e, i))
            if budget is not None and elapsed > budget:
                logger.info("[%s %s delays=%s] Ending training (budget)", env_name, model_name, delays)
                stop = True
                break
        if seg_losses:
            epoch_losses.append([sum(col) / len(seg_losses) for col in zip(*seg_losses)])
        if stop:
            break

    out = {}
    train_seconds = timer.elapsed()
    for i, d in enumerate(delays):
        params_d = slice_tree(params_e, i)
        save_pytree(ckpt_paths[d], params_d)
        out[d] = (model, params_d, {
            "train_loss": last_loss[i],
            "best_val_loss": best_loss[i],
            "epoch_losses": [row[i] for row in epoch_losses],
            "train_seconds": train_seconds,
            "ensemble_delays": delays,
        })
    return out
