"""Traffic of kind ``plant``: one plant in a closed loop with one deployed
controller, ``serving.make_controller(...).step`` every tick.

The plant is the reference environment stepped on the host in float64 under
the action the controller returned ``delay`` ticks before. Each episode of
``episode_ticks`` ticks starts the plant from a drawn state and the
controller from a fresh state with a drawn first plan; the benchmark draws
each tick's perturbations and passes them as ``step(..., noise=)``, then
syncs, so a tick is timed from the observation handed in to the action back
on the host and holds nothing else. The window runs ticks until
``--seconds`` have passed (in a traced run, also until the traced ticks
have run). Traffic keys: ``rollouts``, ``episode_ticks``, ``initial_state``,
``warmup_ticks``, ``trace`` (``start_tick``, ``ticks``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, inputs
from ..cell import Cell
from ..trace import Tracer
from . import Window, port_setup, sync


class Driver:
    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.ticks = int(cell.traffic["episode_ticks"])
        self.env = check.env_module(cell)

    def setup(self):
        from neurallaplacecontrol_tpu_torch import make_controller

        c = self.cell.config
        self.params = inputs.params(self.cell, self.seed, self.device)
        cfg, model = port_setup(self.cell, self.device)
        self.ctrl = make_controller(c["model"], c["env"], c["delay"], cfg, model_apply=model.apply,
                                    params=self.params, roll_outs=self.cell.rollouts,
                                    time_steps=self.cell.horizon, device=self.device)
        # the cell's shapes, once: builds and loads the kernel, fills the allocator
        self._episode(inputs.PlantDraws(self.cell, self.seed, "warmup", self.device),
                      int(self.cell.traffic["warmup_ticks"]), None, None, 0)
        sync(self.device)

    def _episode(self, draws, ticks, deadline, tracer, tick0):
        """Up to ``ticks`` ticks of one episode, or until ``deadline``:
        (observations, actions, plans, tick seconds, step seconds)."""
        c = self.cell.config
        delay, dt = int(c["delay"]), float(c["dt"])
        state = self.ctrl.reset(0)._replace(U=draws.U0)
        raw = draws.raw0.clone()
        plant = torch.zeros((c["action_buffer_size"], c["m"]), dtype=torch.float64)
        observations, actions, plans, tick_s, step_s = [], [], [], [], []
        for it in range(ticks):
            obs = self.env.observe(raw)
            noise = draws.noise()
            sync(self.device)
            if tracer is not None:
                tracer.begin(tick0 + it)
            t0 = time.perf_counter()
            action, state = self.ctrl.step(state, obs, noise=noise)
            t1 = time.perf_counter()
            a = action.cpu()
            t2 = time.perf_counter()
            observations.append(obs)
            actions.append(a)
            plans.append(state.U)
            tick_s.append(t2 - t0)
            step_s.append(t1 - t0)
            plant = torch.cat([plant[1:], a.double()[None]])
            raw, _ = self.env.step(raw, plant[-(delay + 1)], dt)
            if deadline is not None and t2 >= deadline and not (tracer and tracer.pending()):
                break
        return torch.stack(observations), torch.stack(actions), torch.stack(plans), tick_s, step_s

    def window(self, seconds: float, tracer: Tracer | None) -> Window:
        self.episodes = []  # (episode, observations, actions, plans)
        tick_s, step_s = [], []
        t0 = time.perf_counter()
        e = 0
        while True:
            draws = inputs.PlantDraws(self.cell, self.seed, e, self.device)
            obs, acts, plans, ts, ss = self._episode(draws, self.ticks, t0 + seconds, tracer, len(tick_s))
            self.episodes.append((e, obs, acts, plans))
            tick_s += ts
            step_s += ss
            e += 1
            if time.perf_counter() - t0 >= seconds and not (tracer and tracer.pending()):
                break
        if tracer is not None:
            tracer.finish()
        elapsed = time.perf_counter() - t0
        actions = torch.cat([ep[2] for ep in self.episodes])
        limit = tracer.start if tracer is not None else len(step_s)
        return Window(seconds=elapsed, work=len(tick_s) * self.cell.rollouts, attempted=len(tick_s),
                      failed=int(torch.sum(~torch.isfinite(actions).all(dim=-1))), host_tick_s=step_s[:limit],
                      tick_s=tick_s)

    def judge(self, rng: np.random.Generator) -> dict:
        """The judge on one episode of the window, drawn by ``rng`` among the
        whole ones (the longest where none is whole)."""
        whole = [ep for ep in self.episodes if ep[1].shape[0] == self.ticks]
        pool = whole or [max(self.episodes, key=lambda ep: ep[1].shape[0])]
        e, obs, acts, plans = pool[int(rng.integers(len(pool)))]
        self.episodes = []
        draws = inputs.PlantDraws(self.cell, self.seed, e, self.device)
        return check.follow_plant(self.cell, self.params, draws, obs, acts, plans, self.device)

    def control(self, rng: np.random.Generator) -> dict:
        """The control's numbers: the reference in TF32 in the controller's
        place for episode 0, judged as the port is."""
        draws = inputs.PlantDraws(self.cell, self.seed, 0, self.device)
        self.episodes = [(0, *check.control_plant(self.cell, self.params, draws, self.ticks, self.device))]
        return self.judge(rng)
