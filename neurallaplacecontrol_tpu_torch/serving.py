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
package.

``export_controller`` writes the step as a ``torch.export`` artifact, with
the weights as buffers of the exported module and the forward kernel as a
node of its graph (the operator ``torch.ops.nlc.nl_forward``);
``load_controller_step`` replays it with the port's operators registered and
no model code imported. The artifact is made for the controller's device: a
CUDA artifact needs a CUDA device to load, and the JAX function's
``platforms`` has no counterpart. ``persistent_compile_cache`` moves the
builds of the native libraries, the port's only run-time compilation.
"""

from __future__ import annotations

import io
import json
import os
import types
import warnings
import zipfile
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from .config import Config
from .planners import mppi_command, mppi_reset
from .utils.device import resolve_device


class ControllerState(NamedTuple):
    """Everything one planner tick carries to the next."""

    U: torch.Tensor  # [T, nu] receding-horizon control plan (unit scale)
    action_buffer: torch.Tensor  # [A, nu] recent planned actions (env units)
    ages: torch.Tensor  # [A] entry ages for encode_obs_time (seconds)


class Controller:
    """A planner tick bound to one (model, env, delay) triple."""

    def __init__(self, mppi_cfg, mppi_params, dynamics, cost_fn, n_obs, action_delay,
                 action_buffer_size, dtype, device, dynamics_carry_init=None, window_encoder=None,
                 model_name: str = ""):
        self.model_name = model_name
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
    from .training.eval import build_planner
    from .training.rollout import build_running_cost

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
        model_name=model_name,
    )


def _replace_item(seq: tuple, i: int, value) -> tuple:
    items = list(seq)
    items[i] = value
    return type(seq)(*items) if hasattr(seq, "_fields") else tuple(items)


class _TensorSlots:
    """Every place a tensor is reachable from a controller: the attributes
    of the port's objects, the cells of closures, the attributes of
    functions, and the dicts, lists and tuples among them. ``put`` moves
    other tensors into those places (the exported module's buffers, while
    it is traced) and ``restore`` moves the originals back, with every dict
    and list as it was (a cache that the trace filled is emptied again)."""

    def __init__(self, root):
        self.tensors = []  # distinct tensors, in the order first met
        self.slots = []  # (index into tensors, setter)
        self._index, self._seen, self._snapshots = {}, set(), []
        self._visit(root, None, None)

    def _add(self, t, put):
        if id(t) not in self._index:
            self._index[id(t)] = len(self.tensors)
            self.tensors.append(t)
        self.slots.append((self._index[id(t)], put))

    def _visit(self, obj, get, put):
        if isinstance(obj, torch.Tensor):
            self._add(obj, put)
        elif isinstance(obj, tuple):  # rebuilt in its place when an item changes
            for i, item in enumerate(obj):
                self._visit(item, lambda i=i: get()[i], lambda v, i=i: put(_replace_item(get(), i, v)))
        elif id(obj) in self._seen:
            return
        elif isinstance(obj, dict):
            self._seen.add(id(obj))
            self._snapshots.append((obj, dict(obj)))
            for k, v in list(obj.items()):
                self._visit(v, lambda o=obj, k=k: o[k], lambda v, o=obj, k=k: o.__setitem__(k, v))
        elif isinstance(obj, list):
            self._seen.add(id(obj))
            self._snapshots.append((obj, list(obj)))
            for i, v in enumerate(obj):
                self._visit(v, lambda o=obj, i=i: o[i], lambda v, o=obj, i=i: o.__setitem__(i, v))
        elif isinstance(obj, types.FunctionType):
            self._seen.add(id(obj))
            for cell in obj.__closure__ or ():
                try:
                    value = cell.cell_contents
                except ValueError:  # a cell not yet bound
                    continue
                self._visit(value, lambda c=cell: c.cell_contents,
                            lambda v, c=cell: setattr(c, "cell_contents", v))
            self._visit(obj.__dict__, None, None)
        elif type(obj).__module__.startswith(__package__ + ".") and hasattr(obj, "__dict__"):
            self._seen.add(id(obj))
            for k, v in list(vars(obj).items()):
                self._visit(v, lambda o=obj, k=k: getattr(o, k),
                            lambda v, o=obj, k=k: object.__setattr__(o, k, v))

    def put(self, tensors):
        for i, set_ in self.slots:
            set_(tensors[i])

    def restore(self):
        for i, set_ in reversed(self.slots):
            set_(self.tensors[i])
        for obj, snapshot in self._snapshots:
            if isinstance(obj, dict):
                obj.clear()
                obj.update(snapshot)
            else:
                obj[:] = snapshot


class _StepModule(torch.nn.Module):
    """A controller's step as an ``nn.Module`` whose buffers are every
    tensor the step reads (weights, the kernel's repacked buffer, norm
    statistics, the noise covariance): traced, the step reads the buffers,
    so the exported program holds them as its state."""

    def __init__(self, controller: Controller):
        super().__init__()
        self.controller = controller
        self.slots = _TensorSlots(controller)
        for i, t in enumerate(self.slots.tensors):
            # a copy: the trace reads the buffers through the slots, and
            # copies share no storage (the CPU planner's packed weights alias
            # the model's), which the artifact's writer wants
            self.register_buffer(f"t{i}", t.detach().clone())

    def forward(self, U, action_buffer, ages, obs, noise):
        self.slots.put([getattr(self, f"t{i}") for i in range(len(self.slots.tensors))])
        try:
            action, state = self.controller.step(ControllerState(U, action_buffer, ages), obs, noise=noise)
        finally:
            self.slots.restore()
        return action, state.U, state.action_buffer, state.ages


_META = "controller.json"  # the artifact's extra file: what a replay needs besides the program


def export_controller(controller: Controller, path: Optional[str] = None) -> bytes:
    """Export the controller's step with ``torch.export`` and return the
    artifact's bytes (``torch.export.save``); also write them to ``path``
    if given.

    The exported program maps ``(U [T, nu], action_buffer [A, nu], ages
    [A], obs [n_obs], noise [K, T, nu])`` to ``(action, U, action_buffer,
    ages)``: the draw is an input, as ``Controller.step``'s ``noise`` is,
    since the program carries no generator. One eager step on zeros runs
    first (it fills the planner's caches with real tensors, so the trace
    stores none; with the fused planner it launches the kernel T times).
    The artifact is made for the controller's device. A step that cannot
    be traced raises ``NotImplementedError`` naming the family.
    """
    cfg, params = controller.mppi_cfg, controller.mppi_params
    like = dict(dtype=controller.dtype, device=controller.device)
    A, T, nu = controller.action_buffer_size, cfg.horizon, cfg.nu
    inputs = (torch.zeros((T, nu), **like), torch.zeros((A, nu), **like),
              torch.flip(torch.arange(A, **like), dims=(0,)) * cfg.dt, torch.zeros(controller.n_obs, **like),
              torch.zeros((cfg.num_samples, T, nu), **like))
    controller.step(ControllerState(*inputs[:3]), inputs[3], noise=inputs[4])
    try:
        exported = torch.export.export(_StepModule(controller), inputs, strict=False)
    except Exception as e:  # noqa: BLE001 — re-raised with the family named
        raise NotImplementedError(
            f"the {controller.model_name!r} controller's step cannot be exported: {type(e).__name__}: {e}"
        ) from e
    meta = {
        "model_name": controller.model_name, "device": str(controller.device),
        "dtype": str(controller.dtype).removeprefix("torch."), "num_samples": cfg.num_samples,
        "horizon": cfg.horizon, "nu": cfg.nu, "n_obs": controller.n_obs,
        "action_buffer_size": controller.action_buffer_size, "dt": cfg.dt,
        "noise_chol": params.noise_chol.tolist(),
    }
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # the writer warns for every non-contiguous buffer (a transposed
        # weight) and saves it in full all the same
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(exported, buf, extra_files={_META: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(blob)
    return blob


def _read_meta(blob: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        name = next((n for n in zf.namelist() if n.endswith("/" + _META) or n == _META), None)
        if name is None:
            raise ValueError("not an exported controller: the artifact has no " + _META)
        return json.loads(zf.read(name))


def load_controller_step(path_or_bytes, seed: int = 0) -> Callable:
    """Load an exported controller step; returns ``step(state, obs,
    noise=None) -> (action, state)`` over ``ControllerState``s.

    The step draws its noise from a ``torch.Generator`` of its own, seeded
    with ``seed``, as ``Controller.step`` does; a ``noise`` tensor [K, T,
    nu] replaces the draw. Loading needs the port's operators
    (``ops.pallas_nl``, ``ops.pallas_ilt``) and no model code. An artifact
    made for CUDA raises on a machine without CUDA: it is never moved to
    the CPU.
    """
    from .ops import pallas_ilt, pallas_nl  # noqa: F401  (registers torch.ops.nlc.*)

    blob = path_or_bytes
    if isinstance(blob, (str, os.PathLike)):
        blob = Path(blob).read_bytes()
    meta = _read_meta(blob)
    device = resolve_device(meta["device"])
    dtype = getattr(torch, meta["dtype"])
    program = torch.export.load(io.BytesIO(blob)).module()
    chol = torch.tensor(meta["noise_chol"], dtype=dtype, device=device)
    shape = (meta["num_samples"], meta["horizon"], meta["nu"])
    generator = torch.Generator(device=device).manual_seed(seed)

    def step(state: ControllerState, obs, noise: Optional[torch.Tensor] = None):
        obs = torch.as_tensor(obs, dtype=dtype, device=device)
        if noise is None:  # planners.mppi_delay._sample_noise's draw
            noise = torch.randn(shape, generator=generator, dtype=dtype, device=device) @ chol.T
        action, U, buffer, ages = program(state.U, state.action_buffer, state.ages, obs, noise)
        return action, ControllerState(U=U, action_buffer=buffer, ages=ages)

    step.meta = meta
    return step


def persistent_compile_cache(cache_dir: str) -> str:
    """Build the port's native libraries under ``cache_dir`` and return its
    absolute path: the forward kernels (``ops.nl_cuda``, ``nvcc``) and the
    replay-buffer and tick-log libraries (``runtime``, ``g++``), each keyed
    by a hash of its source. A process that starts on a warm ``cache_dir``
    runs no compiler. Call it before the first build in the process; the
    port compiles nothing else at run time (it does not use
    ``torch.compile``)."""
    from .ops import nl_cuda
    from .runtime import _native

    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    nl_cuda.BUILD_DIR = Path(cache_dir) / "nl_kernels"
    _native.BUILD_DIR = Path(cache_dir) / "runtime"
    return cache_dir
