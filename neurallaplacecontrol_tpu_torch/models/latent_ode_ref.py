"""Reference-layout latent ODE, the twin of ``models.latent_ode`` into which
reference ``.pt`` checkpoints transplant (port of ``models/latent_ode_ref.py``).

The port's ``latent_ode`` departs from the Rubanova stack the reference
vendors (encoder hidden = latents, no mask channel, per-row horizons), so a
reference checkpoint cannot load into it. This model has the parameters and
the planning forward of reference ``GeneralLatentODEOfficial``
(w_latent_ode.py:22-227 with baseline_models/latent_ode_lib/), and
``interop.latent_ode_params_from_state_dict`` fills it from a reference
state dict.

The architecture (create_latent_ode_model.py:17-160, defaults of
w_latent_ode.py:55-66: units = gru_units = hidden_units, rec_dims = 20, one
layer each):

- the encoder's hidden state has ``rec_dims`` = 20 dims (not latents);
- the encoder's input is (obs_n || act_n) with an all-ones mask appended
  (latent_ode.py:64-66 ``truth_w_mask``), so the GRU nets see 2 x input_dim
  data channels;
- GRU_unit (encoder_decoder.py:22-103): three nets Linear(2 rec + 2 D,
  units), Tanh, Linear(units, .) for update (sigmoid), reset (sigmoid) and
  the new state (split into mean and std, the std's absolute value);
- the recognition ODE, create_net(rec, rec, 1 layer, units) (3 Linears with
  tanh between, utils.py:300-308), runs backward in time between
  observations by explicit Euler over a linspace grid of ``max(2,
  int(gap / min_step))`` points, ``min_step = interval / 50``
  (encoder_decoder.py:252-310), the 0.01 gap before the newest
  observation included (``prev_t = t[-1] + 0.01``);
- transform_z0: Linear(2 rec, 100), Tanh, Linear(100, 2 latents), std abs;
- latents = state_dim + 2 (w_latent_ode.py:41-44);
- the decoder is one Linear(latents, input_dim) (encoder_decoder.py:330-343).

The gen-ODE net is carried in the tree, so that a checkpoint round-trips,
and never evaluated: the reference's planning and training both hand
``odeint`` one time point (w_latent_ode.py:183-186; batch size 1 in
training, train_utils.py:320-323), for which it returns the initial value.
The prediction is ``Decoder(z0)`` and ``ts`` plays no role, here as there.
z0 is the posterior mean: the reference draws one sample at plan time
(latent_ode.py:73-75), and the mean is the same predictor without the
sampling noise.

The encoder's substep plan depends only on the buffer's fixed times, so it
is made once on the host as Python floats: the card runs one fixed sequence
of operations per call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import linear_apply, linear_init, mlp_apply_tanh, mlp_init, tree_map

_ACTION_LATENT = 2  # w_latent_ode.py:41 action_encoder_latent_dim
_REC_DIMS = 20  # create_latent_ode_model.py:29 rec_dims default
_Z0_TF_UNITS = 100  # encoder_decoder.py:214 transform_z0 hidden width
_FIRST_GAP = 0.01  # encoder_decoder.py:263 prev_t = t[-1] + 0.01


@dataclass(frozen=True)
class RefLatentODEModel(DynamicsModel):
    """The reference-layout latent ODE's entry points beyond the (obs,
    action_buffer, ts) interface; see ``make_ref_latent_ode_model``."""

    encode_z0: Optional[Callable] = None
    predict_diff: Optional[Callable] = None
    state_dim: int = 0
    action_dim: int = 0
    latents: int = 0
    rec_dims: int = 0
    substep_plan: tuple = ()


def _encoder_substep_plan(times: np.ndarray) -> list:
    """The backward-Euler substeps of run_odernn (encoder_decoder.py:252-310)
    on the fixed observation times ``times``.

    Returns ``[(obs_index, [h_0, h_1, ...]), ...]`` in processing order,
    newest observation first: before observation i is read, the hidden mean
    takes explicit Euler steps of the listed (negative) sizes.
    """
    A = len(times)
    interval = float(times[-1] - times[0])
    min_step = interval / 50.0
    plan = []
    prev_t = float(times[-1]) + _FIRST_GAP
    for i in reversed(range(A)):
        t_i = float(times[i])
        gap = prev_t - t_i
        # min_step is 0 on a one-observation grid (action_buffer_size=1),
        # where the reference divides by zero (encoder_decoder.py:276): one
        # explicit step, as for a gap below min_step
        if min_step <= 0.0 or gap < min_step:
            steps = [t_i - prev_t]  # one step of size t_i - prev_t (:265-267)
        else:
            # Euler over linspace(prev_t, t_i, n): n - 1 equal steps
            # (:276-280; torch's .int() truncates toward zero)
            n = max(2, int(gap / min_step))
            steps = [(t_i - prev_t) / (n - 1)] * (n - 1)
        plan.append((i, steps))
        prev_t = t_i
    return plan


def make_ref_latent_ode_model(
    state_dim: int,
    action_dim: int,
    norm: NormStats,
    hidden_units: int = 128,
    rec_dims: int = _REC_DIMS,
    action_buffer_size: int = 4,
    encode_obs_time: bool = False,
    normalize: bool = True,
    normalize_time: bool = True,
    dt: float = 0.05,
    dtype=torch.float32,
    device="cuda",
) -> RefLatentODEModel:
    del encode_obs_time, normalize_time  # the reference latent ODE has neither
    device = resolve_device(device)
    input_dim = state_dim + action_dim  # w_latent_ode.py:40
    latents = state_dim + _ACTION_LATENT  # w_latent_ode.py:42
    enc_in = 2 * input_dim  # the data and the all-ones mask

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    state_mean, state_std = tensor(norm.state_mean), tensor(norm.state_std)
    action_mean, action_std = tensor(norm.action_mean), tensor(norm.action_std)

    times = np.arange(-(action_buffer_size - 1), 1, dtype=np.float64) * dt
    plan = _encoder_substep_plan(times)

    def init(generator=None):
        """Fresh parameters with the JAX tree's keys and shapes, drawn from
        ``generator`` and placed on the model's device."""
        gate = [2 * rec_dims + enc_in, hidden_units]
        params = {
            "rec_ode": mlp_init(generator, [rec_dims, hidden_units, hidden_units, rec_dims], dtype=dtype),
            "gru": {
                "update": mlp_init(generator, gate + [rec_dims], dtype=dtype),
                "reset": mlp_init(generator, gate + [rec_dims], dtype=dtype),
                "state": mlp_init(generator, gate + [2 * rec_dims], dtype=dtype),
            },
            "transform_z0": mlp_init(generator, [2 * rec_dims, _Z0_TF_UNITS, 2 * latents], dtype=dtype),
            "gen_ode": mlp_init(generator, [latents, hidden_units, hidden_units, latents], dtype=dtype),
            "decoder": linear_init(generator, latents, input_dim, dtype=dtype),
        }
        return tree_map(lambda x: x.to(device), params)

    def _gru_update(p, y_mean, y_std, x):
        """GRU_unit (encoder_decoder.py:67-103). The all-ones mask makes the
        masked update a no-op, but the mask channels enter the gate nets
        (inside ``x``)."""
        concat = torch.cat([y_mean, y_std, x], dim=-1)
        update = torch.sigmoid(mlp_apply_tanh(p["update"], concat))
        reset = torch.sigmoid(mlp_apply_tanh(p["reset"], concat))
        new = mlp_apply_tanh(p["state"], torch.cat([y_mean * reset, y_std * reset, x], dim=-1))
        new_mean, new_std = new[..., :rec_dims], torch.abs(new[..., rec_dims:])
        y_mean = (1.0 - update) * new_mean + update * y_mean
        y_std = torch.abs((1.0 - update) * new_std + update * y_std)
        return y_mean, y_std

    def encode_z0(params, x):
        """run_odernn and transform_z0 over normalized windows ``x`` [B, A, D]
        (D = input_dim; the mask is appended here) -> (z0_mean, z0_std), each
        [B, latents]."""
        B = x.shape[0]
        xm = torch.cat([x, torch.ones_like(x)], dim=-1)  # truth_w_mask
        y_mean = x.new_zeros((B, rec_dims))
        y_std = x.new_zeros((B, rec_dims))
        for i, steps in plan:
            for h in steps:
                y_mean = y_mean + h * mlp_apply_tanh(params["rec_ode"], y_mean)
            y_mean, y_std = _gru_update(params["gru"], y_mean, y_std, xm[:, i])
        z = mlp_apply_tanh(params["transform_z0"], torch.cat([y_mean, y_std], dim=-1))
        return z[..., :latents], torch.abs(z[..., latents:])

    def _normalize(obs, actions):
        if normalize:
            return (obs - state_mean) / state_std, (actions - action_mean) / action_std
        return obs, actions / 3.0

    def predict_diff(params, obs_hist, act_hist):
        """The reference's planning forward without sampling: raw history
        obs_hist [B, A, n], act_hist [B, A, m] -> Decoder(z0_mean)[:n]
        (w_latent_ode.py:145-199)."""
        obs_n, act_n = _normalize(obs_hist, act_hist)
        z_mean, _ = encode_z0(params, torch.cat([obs_n, act_n], dim=-1))
        return linear_apply(params["decoder"], z_mean)[..., :state_dim]

    def apply(params, obs, action_buffer, ts):
        """The planner's interface; ``ts`` is ignored (the reference's
        semantics). The history is the current observation tiled; the
        reference instead warms a zero-filled rolling buffer over the first
        A ticks (w_latent_ode.py:160-172)."""
        del ts
        A = action_buffer.shape[1]
        obs_hist = obs[:, None, :].expand(obs.shape[0], A, obs.shape[1])
        return predict_diff(params, obs_hist, action_buffer[..., :action_dim])

    return RefLatentODEModel(
        name="latent_ode_ref", init=init, apply=apply, encode_z0=encode_z0, predict_diff=predict_diff,
        state_dim=state_dim, action_dim=action_dim, latents=latents, rec_dims=rec_dims,
        substep_plan=tuple((i, tuple(steps)) for i, steps in plan),
    )
