"""The comparison that decides ``correct``, and the control that must fail it.

The reference (``reference/``) judges the port tick by tick along the port's
own trajectory. The plan U is state the port carries from tick to tick, and
a planner this sharp is chaotic in it: a reference that carried its own plan
would part from the port's within a few ticks on rounding alone. So each tick
starts from the plan the port returned the tick before (the batch's first
plan at tick 0, which the benchmark drew), the observation the port planned
from, the action buffer built from the port's returned actions, and the
tick's perturbations; the reference plans that tick and steps the plant from
the observation under the action the buffer executes. The numbers, each the
worst over the sampled episodes and all their ticks:

- ``plan_gap``: the returned action's gap over the action bound, and every
  step of the returned plan's gap (unit scale);
- ``transition_gap``: the next observation's and the reward's gap, each
  relative to 1 + |reference|, the first observation's against the batch's
  initial state, and each tick's observation against the next observation
  the tick before recorded, so that a plant state left unchanged from tick
  to tick shows (episode cells only; on every seed of the batch).

In an episode cell the judge follows every seed of the batch for the first
``check.all_seed_ticks`` ticks, then the sampled seeds to the episode's end.

The judge computes in float32 with TF32 off. The control is the reference put
in the port's place one precision lower: the model's and the planner's
products in TF32, the plant's elementwise step in bfloat16.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import namedtuple

import torch

from . import inputs
from .cell import Cell
from .reference import mppi

Records = namedtuple("Records", "s0 a0 sn reward")  # the port's EpisodeRecords fields the judge reads


@contextlib.contextmanager
def tf32(enabled: bool):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def env_module(cell: Cell):
    return importlib.import_module(f"{__package__}.reference.{cell.config['env_reference']}")


class Planner:
    """The reference planner of a cell at one dtype, over the judge's model
    that the cell's adapter builds (``models``)."""

    def __init__(self, cell: Cell, params, device, dtype=torch.float32):
        self.cell, self.env, self.dtype = cell, env_module(cell), dtype
        self.model = cell.model.reference(cell, params, device, dtype)
        self.sigma_inv = torch.linalg.inv(inputs.noise_cov(cell)).to(dtype=dtype, device=device)
        self.u_max = float(cell.config["action_high"])

    def cost(self, obs, action):
        return -(self.env.reward_obs(obs) + self.env.reward_action(action))

    def tick(self, U, obs, buffer, noise):
        return mppi.tick(self.model, self.cost, U, obs, buffer, noise, self.sigma_inv, self.u_max,
                         -self.u_max, self.u_max, float(self.cell.config["mppi_lambda"]))


def _rel(got, ref):
    return float(torch.max(torch.abs(got - ref) / (1.0 + torch.abs(ref))))


def _gap(port_action, port_plan, action, plan, u_max):
    return max(float(torch.max(torch.abs(port_action - action))) / u_max,
               float(torch.max(torch.abs(port_plan - plan))))


def follow_episodes(cell: Cell, params, draws, records, plans, sample, device) -> dict:
    """The judge of one episode batch: ``draws`` replays its inputs
    (``inputs.EpisodeDraws``), ``records`` holds the port's trajectory,
    ``plans`` [S, n, T, nu] the plan it returned each tick, and ``sample``
    the seeds to follow past the first ``check.all_seed_ticks`` ticks."""
    c, delay, dt = cell.config, int(cell.config["delay"]), float(cell.config["dt"])
    all_ticks = int(cell.traffic["check"]["all_seed_ticks"])
    with tf32(False), torch.no_grad():
        ref = Planner(cell, params, device)
        f = lambda x: x.to(device=device, dtype=torch.float32)  # noqa: E731
        s0, a0, sn, reward, plans = f(records.s0), f(records.a0), f(records.sn), f(records.reward), f(plans)
        transition_gap = _rel(s0[:, 0], ref.env.observe(draws.reset_state()))
        if s0.shape[1] > 1:  # the state each tick starts from is the one the tick before ended in
            transition_gap = max(transition_gap, _rel(s0[:, 1:], sn[:, :-1]))
        U = draws.plan0()
        buffer = torch.zeros((s0.shape[0], c["action_buffer_size"], c["m"]), dtype=torch.float32, device=device)
        idx = torch.arange(s0.shape[0], device=device)
        plan_gap = 0.0
        for t in range(s0.shape[1]):
            if t == all_ticks:  # from here on, the sampled seeds alone
                keep = torch.as_tensor(sample, device=device)
                U, buffer, idx = U.index_select(0, keep), buffer.index_select(0, keep), idx.index_select(0, keep)
            noise = draws.planner_noise(t).index_select(0, idx)
            obs, port_action = s0[idx, t], a0[idx, t, -1]
            action, plan = ref.tick(U, obs, buffer, noise)
            plan_gap = max(plan_gap, _gap(port_action, plans[idx, t], action, plan, ref.u_max))
            U = plans[idx, t]
            buffer = torch.cat([buffer[:, 1:], port_action[:, None]], dim=1)
            raw_next, r = ref.env.step(ref.env.raw_from_obs(obs), buffer[:, -(delay + 1)], dt)
            transition_gap = max(transition_gap, _rel(sn[idx, t], ref.env.observe(raw_next)),
                                 _rel(reward[idx, t], r))
    return {"plan_gap": plan_gap, "transition_gap": transition_gap}


def follow_plant(cell: Cell, params, draws, observations, actions, plans, device) -> dict:
    """The judge of one plant episode: ``draws`` replays its first plan and
    perturbations (``inputs.PlantDraws``); ``observations`` [n, n_obs] are
    what the port was handed, ``actions`` [n, nu] and ``plans`` [n, T, nu]
    what it returned."""
    c = cell.config
    with tf32(False), torch.no_grad():
        ref = Planner(cell, params, device)
        obs = observations.to(device=device, dtype=torch.float32)
        port = actions.to(device=device, dtype=torch.float32)
        plans = plans.to(device=device, dtype=torch.float32)
        U = draws.U0[None]
        buffer = torch.zeros((1, c["action_buffer_size"], c["m"]), dtype=torch.float32, device=device)
        plan_gap = 0.0
        for t in range(obs.shape[0]):
            action, plan = ref.tick(U, obs[t][None], buffer, draws.noise()[None])
            plan_gap = max(plan_gap, _gap(port[t], plans[t], action[0], plan[0], ref.u_max))
            U = plans[t][None]
            buffer = torch.cat([buffer[:, 1:], port[t][None, None]], dim=1)
    return {"plan_gap": plan_gap}


def control_episodes(cell: Cell, params, draws, device):
    """The control in the port's place: one episode batch of the reference,
    its products in TF32 and its plant steps in bfloat16, on ``draws``:
    (records, plans [S, n, T, nu])."""
    c, delay, dt = cell.config, int(cell.config["delay"]), float(cell.config["dt"])
    steps = int(cell.traffic["episode_ticks"])
    with tf32(True), torch.no_grad():
        ref = Planner(cell, params, device)
        raw = draws.reset_state()
        U = draws.plan0()
        S = raw.shape[0]
        buffer = torch.zeros((S, c["action_buffer_size"], c["m"]), dtype=torch.float32, device=device)
        out, plans = {k: [] for k in Records._fields}, []
        for t in range(steps):
            obs = ref.env.observe(raw)
            action, U = ref.tick(U, obs, buffer, draws.planner_noise(t))
            plans.append(U)
            buffer = torch.cat([buffer[:, 1:], action[:, None]], dim=1)
            nxt, r = ref.env.step(raw.bfloat16(), buffer[:, -(delay + 1)].bfloat16(), dt)
            raw = nxt.float()
            for k, v in zip(Records._fields, (obs, buffer, ref.env.observe(raw), r.float())):
                out[k].append(v)
    return Records(*(torch.stack(out[k], dim=1) for k in Records._fields)), torch.stack(plans, dim=1)


def control_plant(cell: Cell, params, draws, ticks: int, device):
    """The control in the port's place for one plant episode of ``ticks``
    ticks: (observations [n, n_obs], actions [n, nu], plans [n, T, nu])."""
    c, delay, dt = cell.config, int(cell.config["delay"]), float(cell.config["dt"])
    with tf32(True), torch.no_grad():
        ref = Planner(cell, params, device)
        raw = draws.raw0.clone()
        U = draws.U0[None]
        buffer = torch.zeros((1, c["action_buffer_size"], c["m"]), dtype=torch.float32, device=device)
        plant = torch.zeros((c["action_buffer_size"], c["m"]), dtype=torch.float64)
        observations, actions, plans = [], [], []
        for _ in range(ticks):
            obs = ref.env.observe(raw).float()
            action, U = ref.tick(U, obs.to(device)[None], buffer, draws.noise()[None])
            buffer = torch.cat([buffer[:, 1:], action[:, None]], dim=1)
            a = action[0].cpu()
            observations.append(obs)
            actions.append(a)
            plans.append(U[0])
            plant = torch.cat([plant[1:], a.double()[None]])
            raw, _ = ref.env.step(raw, plant[-(delay + 1)], dt)
    return torch.stack(observations), torch.stack(actions), torch.stack(plans)


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct where every number is finite and within its limit, and every
    limit has its number."""
    return bool(limits) and all(
        k in numbers and numbers[k] == numbers[k] and numbers[k] <= limits[k] for k in limits)
