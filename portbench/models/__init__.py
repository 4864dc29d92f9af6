"""The model adapters: one file per model, ``models/<model>.py``, found by the
``model`` key of a cell's configuration (``cell.load`` calls ``adapter``), so
that the rest of the harness names no model. An adapter module defines:

- ``reference(cell, params, device, dtype)``: the judge's model, built from
  ``reference/`` alone (never from the port), with three methods that
  ``reference.mppi.tick`` calls:

  - ``init_carry(rows)``: the state the model carries from step to step for
    ``rows`` rollouts, or ``None`` for a model that carries nothing;
  - ``prepare(windows)``: the action windows [N, T, A, nu] of N rollouts over
    T steps -> the per-step inputs, indexed ``[:, t]``;
  - ``step(state, inputs_t, carry) -> (next_state, carry)``: one step of the
    N rollouts;

- ``port_config_keys``: the configuration's keys that ``drivers.port_setup``
  hands the port's ``Config``;
- ``planner_apply(port_model)``: what the port's planner builders
  (``training.eval.build_planner``, ``serving.make_controller``) take as
  ``model_apply`` for the port's model, as the port's own table driver hands
  it over (``run_exp_multi_torch._apply_of``): a model's ``apply``, or the
  model itself where its builder plans through more than ``apply`` (the
  latent ODE's carried history);
- ``dims(config)``: the forward's dims, as the yardstick takes them;
- ``flops_per_row(**dims)`` and ``least_seconds(rows, **dims)``: the
  yardstick, the model FLOPs of one forward on one row and the least time a
  forward of ``rows`` rows can take on the chip (the chip's peaks stay in
  ``flops.py``);
- ``counters()``: the program's counts (forwards, rows over them) so far;
- ``is_forward_op(name)``: whether a device operation of that name is the
  forward's.

A model whose forward has no kernel of its own returns False from
``is_forward_op``: its cells list ``mfu`` (from its counters and FLOPs) and
the whole tick's device metrics (``device_ops_per_tick``,
``planner_device_ms``, ``device_idle``), not ``fwd_device_ms`` or
``fwd_roofline``, which would read nothing there. A module that lacks one of
``ENTRIES`` stops the load, naming it.
"""

from __future__ import annotations

import importlib
from pathlib import Path

MODELS_DIR = Path(__file__).resolve().parent
ENTRIES = ("reference", "port_config_keys", "planner_apply", "dims", "flops_per_row", "least_seconds", "counters",
           "is_forward_op")


def adapter(name: str):
    """The adapter module ``models/<name>.py`` of the model ``name``."""
    path = MODELS_DIR / f"{name}.py"
    if not (name.isidentifier() and path.is_file()):
        raise SystemExit(f"no adapter for the model {name!r}: {path.relative_to(MODELS_DIR.parents[1])} is missing")
    module = importlib.import_module(f"{__package__}.{name}")
    missing = [entry for entry in ENTRIES if not hasattr(module, entry)]
    if missing:
        raise SystemExit(f"the adapter for the model {name!r} lacks {', '.join(missing)}")
    return module


def any_forward_op():
    """A test of a device operation's name: whether any model's adapter counts
    it as its forward's. For a trace read without a cell's model."""
    tests = [adapter(p.stem).is_forward_op for p in sorted(MODELS_DIR.glob("*.py")) if p.stem != "__init__"]
    return lambda name: any(test(name) for test in tests)
