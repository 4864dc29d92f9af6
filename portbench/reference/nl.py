"""The Neural Laplace (NL) dynamics model, written from its published description.

Holt et al., "Neural Laplace Control for Continuous-time Delayed Systems"
(AISTATS 2023), model file ``w_nl.py`` of github.com/samholt/NeuralLaplaceControl:

- the action buffer [A, m] is normalized, reversed in time and run through a
  GRU of ``layers`` layers (gates r, z, n; n = tanh(W_in x + b_in + r (W_hn h
  + b_hn)); h' = (1 - z) n + z h); the last layer's last state goes through a
  linear map to a 2-d action latent;
- the observation is normalized and joined with the latent: p [n + 2];
- the query time t (seconds, divided by 8 dt) is floored at 2.5e-3; the
  fourier contour of T = 2 t has the nodes s_k = sigma + i k pi / T, k < N,
  with sigma = 1e-3 - ln(1e-6) / T; each node goes onto the Riemann sphere
  as (atan2(Im s, Re s), asin((|s|^2 - 1) / (|s|^2 + 1)));
- a tanh MLP maps (the nodes' angles, p) to 2 N n outputs, read as angles
  theta = pi tanh(.) and phi = pi/2 tanh(.) of F(s_k) per output dimension;
- F goes back to the plane: phi clipped 1e-4 inside the poles, the radius
  (1 + sin phi) / cos phi on the northern hemisphere and cos phi / (1 - sin
  phi) on the southern one;
- f(t) = e^{sigma t} / T [Re F_0 / 2 + sum_{k>=1} Re F_k cos(k pi t / T) -
  Im F_k sin(k pi t / T)] is the predicted state difference.

The parameters are the checkpoint's tree, in its layout: a linear layer is
``{"w": [in, out], "b": [out]}``, a GRU layer ``{"w_ih", "w_hh", "b_ih",
"b_hh"}`` with the gate blocks in r, z, n order.
"""

from __future__ import annotations

import math

import torch

_ALPHA = 1e-3
_EPS = 1e-6
_T_FLOOR = 2.5e-3
_PHI_MARGIN = 1e-4


def _linear(p, x):
    return x @ p["w"] + p["b"]


def contour_angles(t_model: float, terms: int) -> tuple[list[float], list[float]]:
    """The fourier contour's nodes at the model time ``t_model`` as sphere
    angles (theta_s, phi_s), in float64 on the host."""
    T = 2.0 * t_model
    sigma = _ALPHA - math.log(_EPS) / T
    theta_s, phi_s = [], []
    for k in range(terms):
        omega = math.pi * k / T
        mag2 = sigma * sigma + omega * omega
        theta_s.append(math.atan2(omega, sigma))
        phi_s.append(math.asin(max(-1.0, min(1.0, (mag2 - 1.0) / (mag2 + 1.0)))))
    return theta_s, phi_s


class NLModel:
    """The NL forward at one shared query time ``dt``, split as the planner
    can use it: ``encode`` maps action windows to latents, ``decode`` maps
    (observation, latent) to the state difference over ``dt``."""

    def __init__(self, params, norm: dict, dt: float, terms: int, dtype=torch.float32, device="cpu"):
        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [cast(v) for v in tree]
            return torch.as_tensor(tree).to(dtype=dtype, device=device)

        self.params = cast(params)
        self.dtype, self.device = dtype, torch.device(device)
        like = dict(dtype=dtype, device=device)
        self.state_mean = torch.tensor(norm["state_mean"], **like)
        self.state_std = torch.tensor(norm["state_std"], **like)
        self.action_mean = torch.tensor(norm["action_mean"], **like)
        self.action_std = torch.tensor(norm["action_std"], **like)
        self.n = len(norm["state_mean"])
        self.terms = terms
        self.t = max(dt / (dt * 8.0), _T_FLOOR)  # w_nl.py:123, the time normalization
        theta_s, phi_s = contour_angles(self.t, terms)
        self.nodes = torch.tensor(theta_s + phi_s, **like)  # [2 N]
        T = 2.0 * self.t
        sigma = _ALPHA - math.log(_EPS) / T
        k = torch.arange(terms, dtype=torch.float64)
        phase = math.pi * k * self.t / T
        half = torch.where(k == 0, 0.5, 1.0)
        scale = math.exp(sigma * self.t) / T
        self.w_re = (scale * half * torch.cos(phase)).to(**like)
        self.w_im = (-scale * half * torch.sin(phase)).to(**like)

    def encode(self, windows: torch.Tensor) -> torch.Tensor:
        """Raw action windows [R, A, m] -> action latents [R, 2]."""
        a = (windows - self.action_mean) / self.action_std
        a = torch.flip(a, dims=(1,))
        layers = self.params["encoder"]["gru"]
        hs = [a.new_zeros((a.shape[0], layer["w_hh"].shape[0])) for layer in layers]
        for step in range(a.shape[1]):
            x = a[:, step]
            for i, layer in enumerate(layers):
                H = layer["w_hh"].shape[0]
                gi = x @ layer["w_ih"] + layer["b_ih"]
                gh = hs[i] @ layer["w_hh"] + layer["b_hh"]
                r = torch.sigmoid(gi[:, :H] + gh[:, :H])
                z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
                cand = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
                hs[i] = (1.0 - z) * cand + z * hs[i]
                x = hs[i]
        return _linear(self.params["encoder"]["out"], hs[-1])

    def decode(self, obs: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        """Observations [R, n] and action latents [R, 2] -> state differences [R, n]."""
        R, n, N = obs.shape[0], self.n, self.terms
        obs_n = (obs - self.state_mean) / self.state_std
        x = torch.cat([self.nodes.expand(R, 2 * N), obs_n, latent], dim=1)
        mlp = self.params["laplace_rep"]
        for layer in mlp[:-1]:
            x = torch.tanh(_linear(layer, x))
        out = _linear(mlp[-1], x).reshape(R, 2 * n, N)
        theta = torch.tanh(out[:, :n]) * math.pi
        phi = torch.tanh(out[:, n:]) * (math.pi / 2.0)
        phi = torch.clamp(phi, -math.pi / 2.0 + _PHI_MARGIN, math.pi / 2.0 - _PHI_MARGIN)
        sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
        north = phi >= 0.0
        radius = torch.where(north, 1.0 + sin_phi, cos_phi) / torch.where(north, cos_phi, 1.0 - sin_phi)
        re, im = radius * torch.cos(theta), radius * torch.sin(theta)
        return (re * self.w_re + im * self.w_im).sum(dim=-1)

    def forward(self, obs: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
        """obs [R, n], raw action windows [R, A, m] -> state differences [R, n]."""
        return self.decode(obs, self.encode(windows))
