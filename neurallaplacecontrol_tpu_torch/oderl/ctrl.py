"""CTRL: the ODE-RL model container (dynamics + policy + value function)
(port of ``oderl/ctrl.py``).

Rebuild of reference envs/oderl/ctrl/ctrl.py + policy.py: a frozen spec
(nets + env + hyperparameters) with one parameter tree {f, g, V, logsn};
forward simulation dispatches to the dynamics family (enode / benode /
ibnode / pets / deep_pilco) as CTRL.make_dynamics_model does
(ctrl.py:84-106). ``save`` and ``load`` read and write the JAX package's
``.npz`` tree format, so a CTRL saved by either package loads in the other;
``ctrl_params_from_jax`` carries a JAX ``CTRL.init`` tree across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..utils.checkpoint import from_jax_params_like, load_pytree, save_pytree
from ..utils.device import resolve_device
from .dynamics import as_draws, simulate_deep_pilco, simulate_enode, simulate_pets
from .nets import ApproxNet, make_benn, make_dropout_bnn, make_enn, make_epnn, make_ibnn, make_mlp

DYNAMICS_FAMILIES = ("enode", "benode", "ibnode", "pets", "deep_pilco")

# reference DEFAULT_PAR_MAP (ctrl.py:13-26)
DEFAULTS = dict(
    nl_f=3, nn_f=200, act_f="elu", dropout_f=0.05, n_ens=10,
    nl_g=2, nn_g=200, act_g="relu",
    nl_V=2, nn_V=200, act_V="tanh",
)


@dataclass(frozen=True)
class CTRL:
    env: Any
    dynamics: str
    f_net: ApproxNet  # vector field approximator on [s, a]
    g_net: ApproxNet  # policy MLP (tanh-bounded in policy_apply)
    V_net: ApproxNet  # value MLP
    n_ens: int
    learn_sigma: bool = False
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    @property
    def is_cont(self) -> bool:
        return "ode" in self.dynamics  # ctrl.py:79-81

    @property
    def name(self) -> str:
        return f"{self.env.spec.name}-{self.dynamics}"

    def init(self, generator=None) -> dict:
        g = generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)
        # the stack operates in observation space (reference ctrl.py:23-27:
        # qin = env.n + env.m with env.n the trig obs dim)
        n, m = self.env.spec.n_obs, self.env.spec.m
        return {
            "f": self.f_net.init(g),
            "g": self.g_net.init(g),
            "V": self.V_net.init(g),
            # observation noise scale, -1 init like reset_parameters (ctrl.py:173-177)
            "logsn": -torch.ones(n + m, dtype=self.dtype, device=self.device),
        }

    def policy_apply(self, params, s, t=None):
        """a = tanh(g(s)) * act_rng (policy.py:8-26); s [..., n]."""
        return torch.tanh(self.g_net.apply(params["g"], s)) * self.env.spec.action_high

    def value_apply(self, params, s):
        return self.V_net.apply(params["V"], s)

    def make_policy(self, params) -> Callable:
        return lambda s, t: self.policy_apply(params, s, t)

    def forward_simulate(self, params, draws, H_ts, s0, g=None, L=10, tau=None, compute_rew=False,
                         substeps=10):
        """Simulate L function draws from s0 (ctrl.py:131-171); ``draws`` is a
        ``torch.Generator`` or an ``OderlDraws``-like object.

        H_ts: float horizon in seconds, or a time grid [T+1] (or [N, T+1],
        one per row, for the ODE families). Returns (st [L',N,T,n], rt
        [L',N,T], ts [T]); L' = n_ens for ensemble families, L*P for pets.
        """
        g = g if g is not None else self.make_policy(params)
        H, ts = (H_ts, None) if isinstance(H_ts, (int, float)) else (None, H_ts)
        common = dict(H=H, ts=ts, tau=tau, compute_rew=compute_rew)
        if self.dynamics == "pets":
            return simulate_pets(self.f_net, params["f"], self.env, g, s0, draws, **common)
        if self.dynamics == "deep_pilco":
            return simulate_deep_pilco(self.f_net, params["f"], self.env, g, s0, draws, L=L, **common)
        return simulate_enode(self.f_net, params["f"], self.env, g, s0, draws, L=L, substeps=substeps, **common)

    def ds_dt(self, params, draws, s, a, L=1):
        """Direct vector-field evaluation f([s,a]) for L draws; s [L,N,n]."""
        noise = as_draws(draws).f_noise(self.f_net, params["f"], L)
        return self.f_net.apply(params["f"], torch.cat([s, a], dim=-1), noise)

    def get_L(self, L: int = 1) -> int:
        return self.n_ens if self.f_net.n_ens > 1 else L  # ctrl.py:123-127

    def save(self, params, path: str):
        save_pytree(path, params)

    def load(self, path: str) -> dict:
        """The tree saved at ``path`` (by either package), in this CTRL's
        dtype and on its device; keys and shapes must be ``init``'s."""
        return load_pytree(path, like=self.init())


def make_ctrl(env, dynamics: str, learn_sigma: bool = False, dtype=torch.float32, device="cuda",
              **overrides) -> CTRL:
    """Factory mirroring CTRL.__init__/make_dynamics_model (ctrl.py:29-106)."""
    if dynamics not in DYNAMICS_FAMILIES:
        raise ValueError(f"dynamics must be one of {DYNAMICS_FAMILIES}, got {dynamics!r}")
    unknown = set(overrides) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"make_ctrl: unknown options {sorted(unknown)}")
    kw = {**DEFAULTS, **overrides}
    spec = env.spec
    n, m = spec.n_obs, spec.m  # observation-space dynamics (ctrl.py:23-27)
    qin, qout = n + m, n
    n_ens = kw["n_ens"]
    f_args = dict(n_hid_layers=kw["nl_f"], n_hidden=kw["nn_f"], act=kw["act_f"], dtype=dtype)
    if dynamics == "enode":
        f_net = make_enn(n_ens, qin, qout, **f_args)
    elif dynamics == "benode":
        f_net = make_benn(n_ens, qin, qout, **f_args)
    elif dynamics == "ibnode":
        f_net = make_ibnn(n_ens, qin, qout, **f_args)
    elif dynamics == "pets":
        f_net = make_epnn(n_ens, qin, qout, **f_args)
    else:  # deep_pilco
        f_net = make_dropout_bnn(qin, qout, dropout_rate=kw["dropout_f"], **f_args)
    g_net = make_mlp(n, m, n_hid_layers=kw["nl_g"], n_hidden=kw["nn_g"], act=kw["act_g"], dtype=dtype)
    V_net = make_mlp(n, 1, n_hid_layers=kw["nl_V"], n_hidden=kw["nn_V"], act=kw["act_V"], dtype=dtype)
    return CTRL(env=env, dynamics=dynamics, f_net=f_net, g_net=g_net, V_net=V_net, n_ens=n_ens,
                learn_sigma=learn_sigma, dtype=dtype, device=resolve_device(device))


def ctrl_params_from_jax(ctrl: CTRL, tree, dtype=None) -> dict:
    """A JAX ``CTRL.init`` tree {f, g, V, logsn} (numpy leaves) as the port's
    params for ``ctrl``, on its device, in ``dtype`` (the CTRL's when None);
    the tree must have the keys and shapes of ``ctrl.init``'s."""
    return from_jax_params_like(tree, ctrl.init(), dtype=dtype or ctrl.dtype)
