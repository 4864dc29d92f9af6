"""Uncertainty-aware function approximators for the ODE-RL stack (port of
``oderl/nets.py``).

Rebuilds of reference envs/oderl/utils/{bnn,enn,benn,ibnn,dropout_bnn}.py.
Every family is a frozen ``ApproxNet`` of functions on parameter trees:

    params = net.init(generator)
    noise  = net.draw_noise(params, generator, L)   # None for deterministic draws
    y      = net.apply(params, x, noise)            # x [L,N,n_in] -> [L,N,n_out]
    kl     = net.kl(params)                         # scalar (0 where not defined)
    params = net.shuffle(params, perm)              # permute ensemble members

The function-draw dimension L rides a leading batch axis: a draw is data
(noise tensors or member indices), and each layer is one batched product
over it (``"lni,lio->lno"`` in the JAX package, ``torch.baddbmm`` here).
Ensemble members live on axis 0 of the ensemble params, the reference's
[Nens, in, out] weight layout (enn.py:36-38). ``draw_noise(..., rows=B)``
gives every one of B rows a draw of its own (shape [L, B, ...] where the
JAX package's is [L, 1, ...]); batched per-row simulations read it.

The EPNN draws its Gaussian output noise inside ``apply``: its noise is
the tensor ``eps`` of the output's shape, or a ``torch.Generator`` to draw
it from (its ``draw_noise`` returns the generator, as the JAX one returns
its key), or None for the mean. Dropout masks are float32 at any dtype,
as in the JAX package (``astype(jnp.float32) / keep``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    threshold where it turns into the identity (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros_like(x))


_ACTS = {
    "relu": torch.relu,
    "elu": F.elu,  # alpha 1, as jax.nn.elu
    "celu": F.celu,  # alpha 1, as jax.nn.celu
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": _softplus,
    "swish": F.silu,  # jax.nn.swish is x sigmoid(x), beta 1
    "linear": lambda x: x,
}


def get_act(name: str) -> Callable:
    """reference envs/oderl/utils/utils.py get_act."""
    return _ACTS[name]


@dataclass(frozen=True)
class ApproxNet:
    name: str
    init: Callable  # generator -> params
    apply: Callable  # (params, x [L,N,in], noise) -> [L,N,out]
    draw_noise: Callable  # (params, generator, L, rows=1) -> noise tree or None
    kl: Callable  # params -> scalar
    shuffle: Callable  # (params, perm [n_ens]) -> params (members permuted)
    n_ens: int = 1
    extras: Any = None  # family-specific callables (the EPNN's get_probs)


def _layer_dims(n_in, n_out, n_hid_layers, n_hidden):
    dims = [n_in] + n_hid_layers * [n_hidden] + [n_out]
    return list(zip(dims[:-1], dims[1:]))


def _uniform(generator, shape, low, high, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return low + u * (high - low)


def _normal(generator, shape, dtype):
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def _init_layer(generator, n_in, n_out, dtype, lead=(), gain=1.0):
    """Xavier-uniform weight + fan-in-bounded uniform bias
    (enn.py:49-56 / bnn.py:74-81); ``lead`` stacks members in front."""
    a = gain * math.sqrt(6.0 / (n_in + n_out))
    bound = 1.0 / math.sqrt(n_in)
    return {"W": _uniform(generator, lead + (n_in, n_out), -a, a, dtype),
            "b": _uniform(generator, lead + (1, n_out), -bound, bound, dtype)}


def _acts_for(n_hid_layers, n_layers, act):
    return [get_act(act) if i < n_hid_layers else get_act("linear") for i in range(n_layers)]


def _no_noise(params, generator, L, rows=1):
    return None


def _no_kl(params):
    leaf = params[0]["W"] if isinstance(params, list) else params["layers"][0]["W"]
    return leaf.new_zeros(())


def _no_shuffle(params, perm):
    return params


def _bmm(x, W, b):
    """x [L,N,i] @ W [L,i,o] + b [L,1,o], one batched GEMM."""
    return torch.baddbmm(b, x, W)


# ---------------------------------------------------------------------------
# Plain MLP / variational BNN (reference bnn.py)
# ---------------------------------------------------------------------------

def make_mlp(n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dtype=torch.float32) -> ApproxNet:
    """Deterministic MLP — the reference BNN with bnn=False (the policy and
    value nets, ctrl/policy.py:18, ctrl/ctrl.py:47-53)."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)

    def init(generator):
        return [_init_layer(generator, i, o, dtype) for i, o in shapes]

    def apply(params, x, noise=None):
        for p, a in zip(params, acts):
            x = a(x @ p["W"] + p["b"])
        return x

    return ApproxNet(name="mlp", init=init, apply=apply, draw_noise=_no_noise, kl=_no_kl,
                     shuffle=_no_shuffle)


def make_bnn(n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", logsig0=-3.0,
             dtype=torch.float32) -> ApproxNet:
    """Mean-field variational BNN (bnn.py with bnn=True): every weight/bias
    has (mu, logsig); a function draw samples W = mu + eps * softplus-sig;
    kl() is KL(q || N(0,1)) summed over parameters (bnn.py:159-171). A draw
    is a set of weights, so ``rows`` must be 1."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)

    def init(generator):
        layers = []
        for i, o in shapes:
            mu = _init_layer(generator, i, o, dtype)
            layers.append({"W_mu": mu["W"], "b_mu": mu["b"],
                           "W_ls": _uniform(generator, (i, o), logsig0 - 1, logsig0 + 1, dtype),
                           "b_ls": _uniform(generator, (1, o), logsig0 - 1, logsig0 + 1, dtype)})
        return layers

    def _sig(logsig):
        return torch.log1p(torch.exp(logsig))  # softplus in the reference's form (bnn.py:70-72)

    def draw_noise(params, generator, L, rows=1):
        if rows != 1:
            raise ValueError("a BNN draw is a set of weights; draw per-row weights one row at a time")
        return [{"W": _normal(generator, (L,) + p["W_mu"].shape, p["W_mu"].dtype),
                 "b": _normal(generator, (L,) + p["b_mu"].shape, p["b_mu"].dtype)} for p in params]

    def apply(params, x, noise):
        for p, nz, a in zip(params, noise, acts):
            W = p["W_mu"][None] + nz["W"] * _sig(p["W_ls"])[None]
            b = p["b_mu"][None] + nz["b"] * _sig(p["b_ls"])[None]
            x = a(_bmm(x, W, b))
        return x

    def kl(params):
        total = 0.0
        for p in params:
            for mu, ls in ((p["W_mu"], p["W_ls"]), (p["b_mu"], p["b_ls"])):
                sig = _sig(ls)
                total = total + torch.sum(torch.log(1.0 / sig) + (sig**2 + mu**2) / 2.0 - 0.5)
        return total

    return ApproxNet(name="bnn", init=init, apply=apply, draw_noise=draw_noise, kl=kl, shuffle=_no_shuffle)


# ---------------------------------------------------------------------------
# Deep ensembles (reference enn.py ENN / EPNN)
# ---------------------------------------------------------------------------

def _ens_apply(acts):
    def apply(params, x, noise=None):
        # x [L,N,in] with L == n_ens; per-member weights (enn.py:128-138)
        for p, a in zip(params, acts):
            x = a(_bmm(x, p["W"], p["b"]))
        return x

    return apply


def _ens_shuffle(params, perm):
    return [{k: w[perm] for k, w in p.items()} for p in params]


def _ens_init(shapes, n_ens, dtype):
    def init(generator):
        return [_init_layer(generator, i, o, dtype, lead=(n_ens,)) for i, o in shapes]

    return init


def make_enn(n_ens, n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dtype=torch.float32) -> ApproxNet:
    """Deep ensemble: n_ens independent MLPs, weights stacked on axis 0
    (enn.py:95-143). A function draw IS the ensemble — L must equal n_ens."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)
    return ApproxNet(name="enn", init=_ens_init(shapes, n_ens, dtype), apply=_ens_apply(acts),
                     draw_noise=_no_noise, kl=_no_kl, shuffle=_ens_shuffle, n_ens=n_ens)


def make_epnn(n_ens, n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dtype=torch.float32) -> ApproxNet:
    """Probabilistic ensemble (PETS): each member outputs (mean, logvar)
    with learnable logvar bounds applied through the double-softplus clamp
    (enn.py:146-203); a draw samples mean + eps * sig, where ``sig`` is
    ``get_probs``' second output, exp(logvar), as in the JAX package."""
    shapes = _layer_dims(n_in, 2 * n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)
    base_apply = _ens_apply(acts)
    layers_init = _ens_init(shapes, n_ens, dtype)

    def init(generator):
        dev = generator.device
        return {"layers": layers_init(generator),
                "max_logsig": torch.ones(n_out, dtype=dtype, device=dev),
                "min_logsig": -2.0 * torch.ones(n_out, dtype=dtype, device=dev)}

    def get_probs(params, x):
        out = base_apply(params["layers"], x)
        mean, logvar = out[..., :n_out], out[..., n_out:]
        logvar = params["max_logsig"] - _softplus(params["max_logsig"] - logvar)
        logvar = params["min_logsig"] + _softplus(logvar - params["min_logsig"])
        return mean, torch.exp(logvar)

    def draw_noise(params, generator, L, rows=1):
        return generator  # the output noise is drawn inside apply, of the output's shape

    def apply(params, x, noise):
        mean, sig = get_probs(params, x)
        if noise is None:
            return mean
        eps = _normal(noise, mean.shape, mean.dtype) if isinstance(noise, torch.Generator) else noise
        return mean + eps * sig

    def shuffle(params, perm):
        return {**params, "layers": _ens_shuffle(params["layers"], perm)}

    return ApproxNet(name="epnn", init=init, apply=apply, draw_noise=draw_noise, kl=_no_kl, shuffle=shuffle,
                     n_ens=n_ens, extras={"get_probs": get_probs})


# ---------------------------------------------------------------------------
# Batch ensemble (reference benn.py)
# ---------------------------------------------------------------------------

def make_benn(n_ens, n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dtype=torch.float32) -> ApproxNet:
    """Batch ensemble: one shared weight matrix per layer plus rank-1 fast
    weights r (input scale) and s (output scale) per member; member m
    computes act(((x * r_m) @ W + b) * s_m) (benn.py:69-84)."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)

    def init(generator):
        layers = []
        for i, o in shapes:
            p = _init_layer(generator, i, o, dtype)
            p["r"] = 1.0 + 0.25 * _normal(generator, (n_ens, 1, i), dtype)
            p["s"] = 1.0 + 0.25 * _normal(generator, (n_ens, 1, o), dtype)
            layers.append(p)
        return layers

    def apply(params, x, noise=None):
        for p, a in zip(params, acts):
            x = a(((x * p["r"]) @ p["W"] + p["b"]) * p["s"])
        return x

    def shuffle(params, perm):
        return [{**p, "r": p["r"][perm], "s": p["s"][perm]} for p in params]

    return ApproxNet(name="benn", init=init, apply=apply, draw_noise=_no_noise, kl=_no_kl, shuffle=shuffle,
                     n_ens=n_ens)


# ---------------------------------------------------------------------------
# Implicit BNN (reference ibnn.py)
# ---------------------------------------------------------------------------

def make_ibnn(n_ens, n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dtype=torch.float32) -> ApproxNet:
    """Implicit BNN: shared weights; per-member multiplicative input noise
    z = z_mu + eps * (exp(z_logsig) + 1e-6) at every layer (ibnn.py:79-106);
    kl() compares the member-aggregated z distribution to N(1, 1)
    (ibnn.py:113-122). L must be a multiple of n_ens."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)
    in_dims = [i for i, _ in shapes]

    def init(generator):
        layers = []
        for i, o in shapes:
            p = _init_layer(generator, i, o, dtype)
            p["z_mu"] = 1.0 + 0.25 * _normal(generator, (n_ens, 1, i), dtype)
            p["z_logsig"] = -2.0 + 0.01 * _normal(generator, (n_ens, 1, i), dtype)
            layers.append(p)
        return layers

    def draw_noise(params, generator, L, rows=1):
        return [_normal(generator, (L, rows, d), params[0]["W"].dtype) for d in in_dims]

    def _z(p, eps):
        # eps [L,rows,in] -> [L/n_ens, n_ens, rows, in] pairs draws with members
        sig = torch.exp(p["z_logsig"]) + 1e-6
        e = eps.reshape((-1, n_ens) + eps.shape[1:])
        return (p["z_mu"][None] + e * sig[None]).reshape(eps.shape)

    def apply(params, x, noise):
        for p, eps, a in zip(params, noise, acts):
            x = a((x * _z(p, eps)) @ p["W"] + p["b"])
        return x

    def kl(params):
        total = 0.0
        for p in params:
            mu = torch.mean(p["z_mu"], dim=0)[0]
            sig = torch.sqrt(torch.mean((torch.exp(p["z_logsig"]) + 1e-6) ** 2, dim=0)[0])
            total = total + torch.sum(torch.log(1.0 / sig) + (sig**2 + (mu - 1.0) ** 2) / 2.0 - 0.5)
        return total

    def shuffle(params, perm):
        return [{**p, "z_mu": p["z_mu"][perm], "z_logsig": p["z_logsig"][perm]} for p in params]

    return ApproxNet(name="ibnn", init=init, apply=apply, draw_noise=draw_noise, kl=kl, shuffle=shuffle,
                     n_ens=n_ens)


# ---------------------------------------------------------------------------
# MC dropout (reference dropout_bnn.py)
# ---------------------------------------------------------------------------

def make_dropout_bnn(n_in, n_out, n_hid_layers=2, n_hidden=100, act="relu", dropout_rate=0.05,
                     dtype=torch.float32) -> ApproxNet:
    """MC-dropout BNN: a function draw is a set of per-layer Bernoulli masks
    held fixed along the trajectory (dropout_bnn.py; DeepPILCO uses this)."""
    shapes = _layer_dims(n_in, n_out, n_hid_layers, n_hidden)
    acts = _acts_for(n_hid_layers, len(shapes), act)
    hid_dims = [o for _, o in shapes[:-1]]

    def init(generator):
        return [_init_layer(generator, i, o, dtype) for i, o in shapes]

    def draw_noise(params, generator, L, rows=1):
        keep = 1.0 - dropout_rate
        return [(torch.rand((L, rows, d), generator=generator, device=generator.device) < keep)
                .to(torch.float32) / keep for d in hid_dims]

    def apply(params, x, noise):
        for j, (p, a) in enumerate(zip(params, acts)):
            x = a(x @ p["W"] + p["b"])
            if j < len(hid_dims) and noise is not None:
                x = x * noise[j]
        return x

    return ApproxNet(name="dropout_bnn", init=init, apply=apply, draw_noise=draw_noise, kl=_no_kl,
                     shuffle=_no_shuffle)
