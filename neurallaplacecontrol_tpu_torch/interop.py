"""Checkpoint interop with the reference torch implementation (port of ``interop.py``).

Reference users carry trained checkpoints: torch ``state_dict``s saved by
reference train_utils.py:442,490. This module maps them onto the port's
parameter trees and back, so that a reference model plans in the port
without retraining:

    sd = load_torch_state_dict("nl.pt")                      # the file
    params = nl_params_from_state_dict(sd, device="cuda")    # import
    sd_back = nl_state_dict_from_params(params)              # export

The mapping is exact:

- ``nn.GRU`` stores its gate blocks row-stacked ``[3H, D]`` in (reset,
  update, candidate) order with separate ih/hh biases, the convention of
  ``models.common``'s GRU cell; each matrix maps by a transpose, each bias
  as it is.
- ``nn.Linear`` weights are ``[out, in]`` (transposed), biases as they are.
- The normalization statistics and ``dt`` are buffers of the reference
  module (w_nl.py:112-116) and constructor arguments of the port's models;
  an import drops them, an export emits them when given.

An import gives a tree of torch tensors on ``device`` (in ``dtype``, or in
the state dict's own dtype when None); an export gives ``{name:
np.ndarray}`` in the reference layout. The latent-ODE mapping targets
``models.latent_ode_ref``, the reference-layout twin: the port's
``latent_ode`` differs in its architecture and keeps its own checkpoints.
Plan with imported reference weights through ``make_model("latent_ode_ref",
...)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .utils.device import resolve_device

_GRU_LAYERS = 2  # reference w_nl.py:21 (nn.GRU(..., 2, batch_first=True))
_MLP_SLOTS = (0, 2, 4)  # the Linear positions inside a linear_tanh_stack

_LO_ENC = "model.encoder_z0"
_LO_GATES = ("update", "reset")  # the sigmoid-headed GRU_unit nets
_NET3 = (0, 2, 4)  # create_net(n_layers=1): Linear, Tanh, Linear, Tanh, Linear
_NET2 = (0, 2)  # Sequential(Linear, Tanh, Linear[, Sigmoid])


def _np(x) -> np.ndarray:
    """A torch tensor or an array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class _Importer:
    """Reads ``sd`` (numpy values) into tensors on one device and dtype."""

    def __init__(self, sd: Mapping, device, dtype):
        self.sd = {k: _np(v) for k, v in sd.items()}
        self.device = resolve_device(device)
        self.dtype = dtype

    def tensor(self, key: str, transpose: bool = False) -> torch.Tensor:
        x = self.sd[key]
        x = x.T if transpose else x
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype, device=self.device)

    def linear(self, prefix: str) -> dict:
        return {"w": self.tensor(f"{prefix}.weight", True), "b": self.tensor(f"{prefix}.bias")}

    def seq(self, prefix: str, slots) -> list:
        return [self.linear(f"{prefix}.{i}") for i in slots]

    def gru(self, prefix: str, layer: int) -> dict:
        return {
            "w_ih": self.tensor(f"{prefix}.weight_ih_l{layer}", True),
            "w_hh": self.tensor(f"{prefix}.weight_hh_l{layer}", True),
            "b_ih": self.tensor(f"{prefix}.bias_ih_l{layer}"),
            "b_hh": self.tensor(f"{prefix}.bias_hh_l{layer}"),
        }


def _put_buffers(sd: dict, norm, dt) -> dict:
    """The reference module's registered buffers, when given."""
    if norm is not None:
        sd["state_mean"] = _np(norm.state_mean)
        sd["state_std"] = _np(norm.state_std)
        sd["action_mean"] = _np(norm.action_mean)
        sd["action_std"] = _np(norm.action_std)
    if dt is not None:
        sd["dt"] = np.asarray(dt)
    return sd


def _put_seq(sd: dict, prefix: str, slots, layers) -> None:
    for slot, p in zip(slots, layers):
        sd[f"{prefix}.{slot}.weight"] = _np(p["w"]).T
        sd[f"{prefix}.{slot}.bias"] = _np(p["b"])


def _put_gru(sd: dict, prefix: str, layer: int, p) -> None:
    sd[f"{prefix}.weight_ih_l{layer}"] = _np(p["w_ih"]).T
    sd[f"{prefix}.weight_hh_l{layer}"] = _np(p["w_hh"]).T
    sd[f"{prefix}.bias_ih_l{layer}"] = _np(p["b_ih"])
    sd[f"{prefix}.bias_hh_l{layer}"] = _np(p["b_hh"])


def nl_params_from_state_dict(sd: Mapping, device="cuda", dtype=None) -> dict:
    """Reference ``NeuralLaplaceModel.state_dict()`` -> the port's NL tree.

    Takes torch tensors or numpy arrays as values and ignores the
    normalization and dt buffers. Raises ``KeyError`` naming the first
    missing weight.
    """
    imp = _Importer(sd, device, dtype)
    return {
        "encoder": {
            "gru": [imp.gru("action_encoder.gru", layer) for layer in range(_GRU_LAYERS)],
            "out": imp.linear("action_encoder.linear_out"),
        },
        "laplace_rep": imp.seq("laplace_rep_func.linear_tanh_stack", _MLP_SLOTS),
    }


def nl_state_dict_from_params(params: Mapping, norm=None, dt: float | None = None) -> Dict[str, np.ndarray]:
    """The port's NL tree -> a reference-format state dict (numpy values).

    With ``norm`` (a ``models.base.NormStats``) and ``dt`` the reference's
    buffers are emitted too, so ``load_state_dict(strict=True)`` accepts it;
    without them it holds the weights only (load with ``strict=False``).
    """
    sd: Dict[str, np.ndarray] = {}
    for layer, p in enumerate(params["encoder"]["gru"]):
        _put_gru(sd, "action_encoder.gru", layer, p)
    sd["action_encoder.linear_out.weight"] = _np(params["encoder"]["out"]["w"]).T
    sd["action_encoder.linear_out.bias"] = _np(params["encoder"]["out"]["b"])
    _put_seq(sd, "laplace_rep_func.linear_tanh_stack", _MLP_SLOTS, params["laplace_rep"])
    return _put_buffers(sd, norm, dt)


def nl_arch_from_state_dict(sd: Mapping, state_dim: int, ilt_algorithm: str = "fourier") -> dict:
    """The ``make_nl_model`` arguments a checkpoint was trained with:
    ``{"s_recon_terms", "hidden_units", "gru_in"}``.

    ``s_recon_terms`` is the value to pass for ``ilt_algorithm`` (the one the
    checkpoint was trained with; the weights do not record it). The head
    holds the effective node count, after the CME snap (w_nl.py:86-88), and
    the snap steps the table of valid orders back by two entries, so for
    "cme" the request is the table entry two places after the stored count.
    """
    head = _np(sd["laplace_rep_func.linear_tanh_stack.4.weight"])
    trunk = _np(sd["laplace_rep_func.linear_tanh_stack.0.weight"])
    gru_ih = _np(sd["action_encoder.gru.weight_ih_l0"])
    terms = int(head.shape[0] // (2 * state_dim))
    if ilt_algorithm == "cme":
        from .config import cme_reconstruction_terms

        table = cme_reconstruction_terms()
        idx = table.index(terms)  # ValueError: the head size is no CME order
        if idx + 2 >= len(table):
            raise ValueError(f"CME head of {terms} terms exceeds the valid table")
        terms = table[idx + 2]
    return {"s_recon_terms": terms, "hidden_units": int(trunk.shape[0]), "gru_in": int(gru_ih.shape[1])}


def rnn_params_from_state_dict(sd: Mapping, device="cuda", dtype=None) -> dict:
    """Reference ``RNN`` / ``DeltaTRNN`` state dict -> the port's tree.

    Both reference classes (train_utils.py:552-631) are one GRU layer and a
    linear head, ``models.rnn``'s ``{"gru": [layer0], "out": {...}}``.
    """
    imp = _Importer(sd, device, dtype)
    return {"gru": [imp.gru("gru", 0)], "out": imp.linear("linear_out")}


def rnn_state_dict_from_params(params: Mapping, norm=None, dt: float | None = None) -> Dict[str, np.ndarray]:
    """The inverse of ``rnn_params_from_state_dict``, with the buffers of
    train_utils.py:560-570 when ``norm``/``dt`` are given."""
    sd: Dict[str, np.ndarray] = {}
    _put_gru(sd, "gru", 0, params["gru"][0])
    sd["linear_out.weight"] = _np(params["out"]["w"]).T
    sd["linear_out.bias"] = _np(params["out"]["b"])
    return _put_buffers(sd, norm, dt)


def node_params_from_state_dict(sd: Mapping, device="cuda", dtype=None) -> dict:
    """Reference ``NODE`` state dict -> the port's tree: the vector field's
    MLP (train_utils.py:637-662); the solver is constructor config."""
    imp = _Importer(sd, device, dtype)
    return {"ode_func": imp.seq("x_ode_func_in_x_and_u.linear_tanh_stack", _MLP_SLOTS)}


def latent_ode_params_from_state_dict(sd: Mapping, device="cuda", dtype=None) -> dict:
    """Reference ``GeneralLatentODEOfficial.state_dict()`` -> the
    ``models.latent_ode_ref`` tree.

    The keys follow create_latent_ode_model.py:17-160 under the module's
    ``model`` attribute (w_latent_ode.py:55-66): the GRU_unit's gate nets and
    transform_z0 are 2-Linear Sequentials (slots 0, 2), both ODE nets
    3-Linear create_net stacks (slots 0, 2, 4), the decoder one Linear. The
    normalization and dt buffers are dropped.
    """
    imp = _Importer(sd, device, dtype)
    return {
        "rec_ode": imp.seq(f"{_LO_ENC}.z0_diffeq_solver.ode_func.gradient_net", _NET3),
        "gru": {
            "update": imp.seq(f"{_LO_ENC}.GRU_update.update_gate", _NET2),
            "reset": imp.seq(f"{_LO_ENC}.GRU_update.reset_gate", _NET2),
            "state": imp.seq(f"{_LO_ENC}.GRU_update.new_state_net", _NET2),
        },
        "transform_z0": imp.seq(f"{_LO_ENC}.transform_z0", _NET2),
        "gen_ode": imp.seq("model.diffeq_solver.ode_func.gradient_net", _NET3),
        "decoder": imp.linear("model.decoder.decoder.0"),
    }


def latent_ode_state_dict_from_params(params: Mapping, norm=None, dt: float | None = None) -> Dict[str, np.ndarray]:
    """The ``models.latent_ode_ref`` tree -> a reference-format state dict,
    with the buffers of w_latent_ode.py:48-52 when ``norm``/``dt`` are given."""
    sd: Dict[str, np.ndarray] = {}
    _put_seq(sd, f"{_LO_ENC}.z0_diffeq_solver.ode_func.gradient_net", _NET3, params["rec_ode"])
    for gate in (*_LO_GATES, "state"):
        key = "new_state_net" if gate == "state" else f"{gate}_gate"
        _put_seq(sd, f"{_LO_ENC}.GRU_update.{key}", _NET2, params["gru"][gate])
    _put_seq(sd, f"{_LO_ENC}.transform_z0", _NET2, params["transform_z0"])
    _put_seq(sd, "model.diffeq_solver.ode_func.gradient_net", _NET3, params["gen_ode"])
    sd["model.decoder.decoder.0.weight"] = _np(params["decoder"]["w"]).T
    sd["model.decoder.decoder.0.bias"] = _np(params["decoder"]["b"])
    return _put_buffers(sd, norm, dt)


def latent_ode_arch_from_state_dict(sd: Mapping) -> dict:
    """The ``make_ref_latent_ode_model`` arguments of a checkpoint:
    ``{"state_dim", "action_dim", "hidden_units", "rec_dims"}``. latents =
    state_dim + 2 is the reference's rule (w_latent_ode.py:41-44); input_dim
    = state_dim + action_dim is the decoder's width."""
    update0 = _np(sd[f"{_LO_ENC}.GRU_update.update_gate.0.weight"])
    update2 = _np(sd[f"{_LO_ENC}.GRU_update.update_gate.2.weight"])
    dec = _np(sd["model.decoder.decoder.0.weight"])
    state_dim = int(dec.shape[1]) - 2
    return {
        "state_dim": state_dim,
        "action_dim": int(dec.shape[0]) - state_dim,
        "hidden_units": int(update0.shape[0]),
        "rec_dims": int(update2.shape[0]),
    }


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference checkpoint file into a numpy state dict
    (``torch.load(..., weights_only=True)`` on the CPU). The reference saves
    bare state dicts (train_utils.py:442,490); a ``{"model_state_dict":
    ...}`` wrapper is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: _np(v) for k, v in obj.items()}
