"""Drivers of the traffic kinds: ``drivers/<kind>.py`` has a ``Driver`` with
``setup()``, ``window(seconds, tracer) -> Window``, ``judge(rng)`` and
``control(rng)`` (the numbers that decide ``correct``, of the port and of the
control)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    """What one measured window did."""

    seconds: float  # its time on the host clock, ending on a device sync
    work: int  # rollouts planned: K a plan over every plan of the window
    attempted: int  # answers due: episodes, or ticks
    failed: int  # answers that were not finite
    host_tick_s: list = field(default_factory=list)  # host seconds to issue a tick, before any trace
    tick_s: list = field(default_factory=list)  # seconds from the observation in to the action out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_setup(cell, device):
    """The port's ``Config`` for the cell and its model (whose ``apply`` the
    planner builders take; the fused route rebuilds the forward), with
    PyTorch's TF32 set as the configuration states."""
    import neurallaplacecontrol_tpu_torch as port

    c = cell.config
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(c["tf32"])
    cfg = port.Config(fused_nl_planner=c["fused_nl_planner"], nl_hidden_units=c["nl_hidden_units"],
                      nl_s_recon_terms=c["nl_s_recon_terms"], nl_ilt_algorithm=c["nl_ilt_algorithm"],
                      nl_compute_dtype=c["nl_compute_dtype"], action_buffer_size=c["action_buffer_size"],
                      dt=c["dt"], mppi_lambda=c["mppi_lambda"], mppi_sigma=c["mppi_sigma"])
    return cfg, port.make_model(c["model"], c["env"], c["n_obs"], c["m"], c["action_high"], cfg, device=device)
