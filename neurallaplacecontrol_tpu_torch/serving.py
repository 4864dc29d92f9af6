"""Deployment-facing controller: one planner tick as a service (port of ``serving.py``).

``make_controller`` returns a ``Controller`` whose ``reset``/``step`` pair
runs over an explicit ``ControllerState``: the plant sends an observation
and gets the planned action back; the receding-horizon plan ``U``, the
action-history buffer the delay-aware models condition on and the entry
ages live in the state. Randomness comes from the controller's own
``torch.Generator``, seeded by ``reset``; ``step`` also takes a pre-sampled
``noise`` tensor, which replaces the draw.

The tick mirrors one iteration of the reference episode loop
(mppi_with_model.py:244-268): plan from the current observation, push the
planned action into the history buffer, advance the entry ages by the
nominal control interval. The delay is the plant's: ``step`` returns the
freshly planned action and the caller's plant applies it ``delay`` ticks
late.

The planner is ``training.eval``'s: the oracle, or a learned family, the
latent ODE with carried or tiled history as its ``model_apply`` says. With
``Config.fused_nl_planner`` the NL planner dynamics run through the fused
forward kernel (ops.pallas_nl), as ``training/eval.py`` does in the JAX
package. Exporting the step and the compile cache of the JAX module are
later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import Config
from .planners import mppi_command, mppi_reset
from .training.eval import build_planner
from .training.rollout import build_running_cost
from .utils.device import resolve_device


class ControllerState(NamedTuple):
    """Everything one planner tick carries to the next."""

    U: torch.Tensor  # [T, nu] receding-horizon control plan (unit scale)
    action_buffer: torch.Tensor  # [A, nu] recent planned actions (env units)
    ages: torch.Tensor  # [A] entry ages for encode_obs_time (seconds)


class Controller:
    """A planner tick bound to one (model, env, delay) triple."""

    def __init__(self, mppi_cfg, mppi_params, dynamics, cost_fn, n_obs, action_delay,
                 action_buffer_size, dtype, device, dynamics_carry_init=None, window_encoder=None):
        self.mppi_cfg = mppi_cfg
        self.mppi_params = mppi_params
        self.dynamics = dynamics
        self.cost_fn = cost_fn
        self.n_obs = n_obs
        self.action_delay = action_delay
        self.action_buffer_size = action_buffer_size
        self.dtype = dtype
        self.device = device
        self.dynamics_carry_init = dynamics_carry_init
        self.window_encoder = window_encoder
        self.generator = torch.Generator(device=device)

    def reset(self, seed: int = 0) -> ControllerState:
        """Seed the controller's generator and return a fresh state."""
        self.generator.manual_seed(seed)
        A, nu, dt = self.action_buffer_size, self.mppi_cfg.nu, self.mppi_cfg.dt
        return ControllerState(
            U=mppi_reset(self.generator, self.mppi_cfg, self.mppi_params),
            action_buffer=torch.zeros((A, nu), dtype=self.dtype, device=self.device),
            # flip(arange(A)) * dt, the collector's age init
            ages=torch.flip(torch.arange(A, dtype=self.dtype, device=self.device), dims=(0,)) * dt,
        )

    def step(self, state: ControllerState, obs, noise: Optional[torch.Tensor] = None):
        """(state, obs [nx]) -> (action [nu], next state)."""
        obs = torch.as_tensor(obs, dtype=self.dtype, device=self.device)
        action, U, _ = mppi_command(
            self.mppi_cfg, self.mppi_params, self.dynamics, self.cost_fn,
            state.U, obs, state.action_buffer,
            generator=self.generator, noise=noise,
            time_buffer=state.ages if self.mppi_cfg.encode_obs_time else None,
            dynamics_carry_init=self.dynamics_carry_init, window_encoder=self.window_encoder,
        )
        buffer = torch.roll(state.action_buffer, -1, dims=0)
        buffer[-1] = action
        # serving ticks at the nominal control interval
        ages = torch.roll(state.ages, -1) + self.mppi_cfg.dt
        ages[-1] = 0.0
        return action, ControllerState(U=U, action_buffer=buffer, ages=ages)


def make_controller(
    model_name: str,
    env_name: str,
    action_delay: int,
    config: Config = Config(),
    model_apply=None,
    params=None,
    roll_outs: Optional[int] = None,
    time_steps: Optional[int] = None,
    state_constraint: bool = False,
    dtype=torch.float32,
    device="cuda",
) -> Controller:
    """Assemble the serving controller (the JAX ``serving.make_controller``).

    ``model_name`` is "oracle" (no model), or a learned family with
    ``model_apply``/``params`` supplied (``models.make_model(...).apply`` and
    ``utils.checkpoint.load_pytree``), planned as ``training.eval.build_planner``
    plans it. For "latent_ode", pass the model itself as ``model_apply`` to
    plan with carried history, its ``apply`` for tiled history. With
    ``config.fused_nl_planner`` the NL planner runs the fused forward kernel
    on ``params`` (float32 only) in place of ``model_apply``.
    """
    if model_name == "random":
        raise ValueError("the random policy plans nothing: there is no controller to serve")
    env, mppi_cfg, mppi_params, dynamics, carry_init, encoder = build_planner(
        model_name, env_name, action_delay, config, model_apply, params, roll_outs, time_steps,
        dtype=dtype, device=device)
    return Controller(
        mppi_cfg=mppi_cfg,
        mppi_params=mppi_params,
        dynamics=dynamics,
        cost_fn=build_running_cost(env, state_constraint=state_constraint),
        n_obs=env.spec.n_obs,
        action_delay=action_delay,
        action_buffer_size=config.action_buffer_size,
        dtype=dtype,
        device=resolve_device(device),
        dynamics_carry_init=carry_init,
        window_encoder=encoder,
    )
