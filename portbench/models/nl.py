"""The adapter of the Neural Laplace model (``"model": "nl"``): the reference
``reference.nl.NLModel`` with the fourier ILT, the nine configuration keys
the port's ``Config`` takes, the model's ``apply`` for the planner builders
(which swap in the fused forward under ``fused_nl_planner``), the forward's
dims and yardstick
(``flops.forward_*``), the forward counters of ``ops.pallas_nl``'s
``nl_forward_fused``, and the names of the forward's kernels (the resident
kernel and the streamed chain's stage kernels).
"""

from __future__ import annotations

import re

from ..reference.nl import NLModel

FORWARD_KERNEL = re.compile(r"\bnl_(forward|wide_\w+)_kernel\b")

port_config_keys = ("fused_nl_planner", "nl_hidden_units", "nl_s_recon_terms", "nl_ilt_algorithm",
                    "nl_compute_dtype", "action_buffer_size", "dt", "mppi_lambda", "mppi_sigma")


def reference(cell, params, device, dtype) -> NLModel:
    c = cell.config
    if c["nl_ilt_algorithm"] != "fourier":
        raise ValueError("the reference is the NL model with the fourier ILT")
    return NLModel(params, c["norm"], c["dt"], c["nl_s_recon_terms"], dtype=dtype, device=device)


def planner_apply(port_model):
    return port_model.apply


def dims(config: dict) -> dict:
    return {"n_obs": config["n_obs"], "m_act": config["m"], "width": config["nl_hidden_units"],
            "gru_hidden": config["nl_hidden_units"] // 2, "terms": config["nl_s_recon_terms"],
            "actions": config["action_buffer_size"], "gru_layers": config["gru_layers"]}


# ``flops`` loads where a metric reads the yardstick, after the window: set-up loads this file alone
def flops_per_row(**dims) -> int:
    from .. import flops

    return flops.forward_flops_per_row(**dims)


def least_seconds(rows: int, **dims) -> float:
    from .. import flops

    return flops.forward_least_seconds(rows, **dims)


def counters() -> tuple[int, int]:
    from neurallaplacecontrol_tpu_torch.ops.pallas_nl import nl_forward_fused

    return nl_forward_fused.launches, nl_forward_fused.rows


def is_forward_op(name: str) -> bool:
    return FORWARD_KERNEL.search(name) is not None
