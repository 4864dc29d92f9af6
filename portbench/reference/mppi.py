"""One tick of delay-aware MPPI (Williams et al. 2017, Algorithm 2, with the
action-history buffer of the Neural Laplace Control paper), in plain PyTorch.

For S independent plans, each with its own K sampled perturbations:

  1. U <- U shifted one step ahead, its last step 0;
  2. perturbed = clip(U + eps, [u_min, u_max] in env units); eps = perturbed - U;
  3. each rollout's action window at horizon step t is the buffer's newest
     A - 1 actions followed by the rollout's scaled actions, t .. t + A - 1
     of the joined sequence;
  4. the state rolls forward through the model, state += f(state, window),
     and pays the running cost -(reward(state) + reward(action_t));
  5. cost += lambda sum_t U_t Sigma^-1 eps_t;
  6. omega = softmax(-(cost - min cost) / lambda) over the K rollouts;
     U += sum_k omega_k eps_k;
  7. the action is u_scale U_0.
"""

from __future__ import annotations

import torch


def tick(model, running_cost, U_prev, obs, buffer, noise, sigma_inv, u_scale: float, u_min: float,
         u_max: float, lam: float):
    """(action [S, nu], U [S, T, nu]) of one tick from the previous plan
    ``U_prev`` [S, T, nu], the observations [S, n], the action buffers before
    the tick [S, A, nu] (env units, oldest first) and the perturbations
    ``noise`` [S, K, T, nu]. ``model`` has ``encode`` and ``decode``
    (``reference.nl.NLModel``); every window is encoded at once before the
    rollout, which is the same function as encoding each at its step."""
    S, K, T, nu = noise.shape
    A = buffer.shape[1]
    U = torch.cat([U_prev[:, 1:], torch.zeros_like(U_prev[:, :1])], dim=1)
    perturbed = torch.clamp((U[:, None] + noise) * u_scale, u_min, u_max) / u_scale
    eps = perturbed - U[:, None]
    scaled = perturbed * u_scale  # [S, K, T, nu]
    joined = torch.cat([buffer[:, None, 1:].expand(S, K, A - 1, nu), scaled], dim=2)
    windows = torch.stack([joined[:, :, t:t + A] for t in range(T)], dim=2)  # [S, K, T, A, nu]
    latents = model.encode(windows.reshape(S * K * T, A, nu)).reshape(S * K, T, -1)
    state = obs[:, None].expand(S, K, obs.shape[-1]).reshape(S * K, -1)
    actions = scaled.reshape(S * K, T, nu)
    cost = torch.zeros(S * K, dtype=state.dtype, device=state.device)
    for t in range(T):
        state = state + model.decode(state, latents[:, t])
        cost = cost + running_cost(state, actions[:, t])
    cost = cost.reshape(S, K) + lam * torch.sum(U[:, None] * (eps @ sigma_inv), dim=(2, 3))
    weights = torch.exp(-(cost - cost.min(dim=1, keepdim=True).values) / lam)
    omega = weights / weights.sum(dim=1, keepdim=True)
    U = U + torch.sum(omega[:, :, None, None] * eps, dim=1)
    return U[:, 0] * u_scale, U
