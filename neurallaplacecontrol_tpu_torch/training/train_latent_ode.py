"""Latent-ODE training (port of ``training/train_latent_ode.py``).

The latent ODE trains on history windows built from consecutive dataset
rows (reference train_utils.py:371-378 via tensor.unfold): window i's
encoder sees the observations and actions of rows [i .. i+A-1] and regresses
the reference's target sn[i] - s0[i+A-1] at horizon ts[i]
(``build_history_windows``). The loss is the IWAE bound of
``models.latent_ode`` ``train_step`` (reference w_latent_ode.py:97-131).

The update is the JAX module's: the optimizer chain of ``training.train``
(zap non-finite gradients, clip, Adam) with no loss cap and no
reject-don't-clip guard; a segment is a Python loop of autograd steps. The
data, the batch order and the IWAE draws come from the port's own seeded
generators (JAX's keys give other values): each segment draws its own fresh
[updates, 3, batch, latents] block, and ``make_latent_ode_segment_fn`` takes
that block as an argument, so a test can hand in JAX's draws.
"""

from __future__ import annotations

import logging

import torch

from ..config import Config
from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..utils.checkpoint import save_pytree
from ..utils.timing import Timer
from .train import Optimizer, get_epoch_data, make_optimizer

logger = logging.getLogger(__name__)

_IWAE_SAMPLES = 3


def build_history_windows(s0, a0, sn, ts, window: int):
    """[N, ...] rows -> ([M, A, n] states, [M, A, m] actions, [M, n] targets,
    [M, 1] horizons), M = N - A + 1.

    The reference's alignment, kept for parity (train_utils.py:373-378,
    :391-398): window i is paired with the first M rows of (sn, ts), so its
    target is sn[i] - hist_s[i, -1] at horizon ts[i], and the target state
    comes before the window's newest frame. The actions are each row's
    newest buffered action (train_utils.py:372)."""
    N = s0.shape[0]
    M = N - window + 1
    idx = torch.arange(M, device=s0.device)[:, None] + torch.arange(window, device=s0.device)[None, :]
    hist_s = s0[idx]
    hist_a = a0[:, -1, :][idx]
    return hist_s, hist_a, sn[:M] - hist_s[:, -1, :], ts[:M]


def make_latent_ode_segment_fn(model, optimizer: Optimizer):
    """One training segment of the latent ODE: ``segment_fn(params,
    opt_state, eps, hist_s, hist_a, target, ts, batch_idx) -> (params,
    opt_state, losses [U])`` over ``batch_idx`` [U, bs], update u drawing
    z0's noise from ``eps[u]`` [3, bs, latents]. Every update is applied."""

    def segment_fn(params, opt_state, eps, hist_s, hist_a, target, ts, batch_idx):
        params = tree_map(torch.Tensor.detach, params)
        losses = []
        for u, idx in enumerate(batch_idx):
            leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
            loss = model.train_step(tree_unflatten(params, leaves), eps[u], hist_s[idx], hist_a[idx], ts[idx],
                                    target[idx])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                updates, opt_state = optimizer.update(tree_unflatten(params, grads), opt_state, params)
                params = tree_map(lambda x, d: (x + d).to(x.dtype), params, updates)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return segment_fn


def train_latent_ode(model, params, env, env_name, config: Config, delay, ckpt_path,
                     end_training_after_seconds=None, dtype=torch.float32, device="cuda"):
    """Train the latent ODE from ``params`` (``training.train_model``'s branch
    for it). Returns (model, params, results)."""
    optimizer = make_optimizer(config)
    opt_state = optimizer.init(params)
    segment_fn = make_latent_ode_segment_fn(model, optimizer)
    batch_size = config.training_batch_size
    A = config.action_buffer_size

    budget = end_training_after_seconds if end_training_after_seconds is not None else config.end_training_after_seconds
    timer = Timer()
    best_loss = float("inf")
    epoch_losses = []
    data_gen = torch.Generator().manual_seed(1)
    noise_gen = torch.Generator(device=device).manual_seed(1)
    seen_shapes = set()
    stop = False
    last_loss = float("nan")

    for epoch_i in range(config.training_epochs):
        # the budget also guards the epoch loop: tiny datasets can yield zero
        # segments, and then the per-segment cutoff below never runs
        if budget is not None and timer.elapsed() > budget:
            break
        data_seed = int(torch.randint(0, 2**62, (1,), generator=data_gen))
        with timer.exclude():
            s0, a0, sn, ts = get_epoch_data(env, env_name, delay, config, data_seed, dtype, device)
            hist_s, hist_a, target, ts_m = build_history_windows(s0, a0, sn, ts, A)
        n = hist_s.shape[0]
        perm = torch.randperm(n, generator=data_gen)
        n_batches = n // batch_size
        seg_len = max(1, min(config.iters_per_log, n_batches))
        n_segments = n_batches // seg_len
        batches = perm[: n_segments * seg_len * batch_size].reshape(n_segments, seg_len, batch_size).to(device)
        seg_losses = []
        for seg_i in range(n_segments):
            # fresh IWAE draws for every segment
            eps = torch.randn((seg_len, _IWAE_SAMPLES, batch_size, model.latents), generator=noise_gen,
                              dtype=dtype, device=device)
            shape_key = (seg_len, batch_size, n)
            if shape_key not in seen_shapes:
                with timer.exclude():  # the first segment of a shape is set-up
                    params, opt_state, losses = segment_fn(params, opt_state, eps, hist_s, hist_a, target, ts_m,
                                                           batches[seg_i])
                    losses = losses.cpu()
                seen_shapes.add(shape_key)
            else:
                params, opt_state, losses = segment_fn(params, opt_state, eps, hist_s, hist_a, target, ts_m,
                                                       batches[seg_i])
                losses = losses.cpu()
            track = float(torch.mean(losses))
            last_loss = float(losses[-1])
            seg_losses.append(track)
            elapsed = timer.elapsed()
            logger.info("[%s latent_ode d=%d][epoch=%04d|seg=%03d|t=%.0f/%s] loss=%g",
                        env_name, delay, epoch_i + 1, seg_i + 1, elapsed, budget, track)
            if track < best_loss:
                best_loss = track
                with timer.exclude():
                    save_pytree(ckpt_path, params)
            if budget is not None and elapsed > budget:
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
        "total_reward": None,
        "train_seconds": timer.elapsed(),
    }
    return model, params, results
