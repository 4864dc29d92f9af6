"""Traffic of kind ``episodes``: the paper's evaluation protocol, batches of S
seeds in lockstep, back to back.

Each batch is the episode that ``training.rollout.make_episode_fn`` builds
over ``training.eval.build_planner`` (as ``training.eval.evaluate_policy``
runs it), driven by ``inputs.EpisodeDraws`` in place of the port's
``SeedDraws``. Its planner is the port's ``planners.mppi_command`` on
``build_planner``'s dynamics and running cost, handed in as the episode's
``command_fn``: the call ``make_episode_fn`` makes itself, through the hook
it documents, so that the plan each tick returns (state the episode does not
record) reaches the judge. The window runs whole batches until ``--seconds`` have
passed, the batch that crosses the end included, each ending on a device
sync. Traffic keys: ``seeds`` (S), ``episode_ticks``, ``initial_state``,
``warmup_ticks``, ``check.seeds`` (episodes the judge follows to the end),
``check.all_seed_ticks`` (ticks it follows every episode for), ``trace``
(``start_tick``, ``ticks``), and optionally ``rollouts`` and ``horizon``.
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
        self.S = int(cell.traffic["seeds"])
        self.ticks = int(cell.traffic["episode_ticks"])

    def setup(self):
        from neurallaplacecontrol_tpu_torch.planners import mppi_command
        from neurallaplacecontrol_tpu_torch.training.eval import build_planner
        from neurallaplacecontrol_tpu_torch.training.rollout import (
            EpisodeSettings,
            build_running_cost,
            make_episode_fn,
        )

        c = self.cell.config
        self.params = inputs.params(self.cell, self.seed, self.device)
        cfg, model = port_setup(self.cell, self.device)
        env, mppi_cfg, mppi_params, dynamics, carry, encoder = build_planner(
            c["model"], c["env"], c["delay"], cfg, model_apply=model.apply, params=self.params,
            roll_outs=self.cell.rollouts, time_steps=self.cell.horizon, device=self.device)

        running_cost = build_running_cost(env)
        self.plans = []  # the plan each tick of the running batch returned

        def command(U, obs, buffer, noise=None, time_buffer=None, cost_args=()):
            action, U, aux = mppi_command(mppi_cfg, mppi_params, dynamics, running_cost, U, obs, buffer,
                                          noise=noise, time_buffer=time_buffer, cost_args=cost_args,
                                          dynamics_carry_init=carry, window_encoder=encoder)
            self.plans.append(U)
            return action, U, aux

        def episode_fn(n_steps):
            settings = EpisodeSettings(delay=c["delay"], n_steps=n_steps, action_buffer_size=c["action_buffer_size"])
            return make_episode_fn(env, dynamics, mppi_cfg, mppi_params, settings, command_fn=command)

        self.episode = episode_fn(self.ticks)
        # the cell's shapes, once: builds and loads the kernel, fills the allocator
        episode_fn(int(self.cell.traffic["warmup_ticks"]))(inputs.EpisodeDraws(self.cell, self.seed, "warmup",
                                                                              self.device))
        sync(self.device)

    def window(self, seconds: float, tracer: Tracer | None) -> Window:
        stamps = []  # (batch, tick, host time) at each tick's start
        self.batches = []  # (batch, records, plans) of every batch the window ran
        totals = []

        def on_tick(batch):
            def mark(it):
                stamps.append((batch, it, time.perf_counter()))
                if tracer is not None:
                    tracer.begin(batch * self.ticks + it)
            return mark

        t0 = time.perf_counter()
        b = 0
        while True:
            draws = inputs.EpisodeDraws(self.cell, self.seed, b, self.device, on_tick=on_tick(b))
            self.plans = []
            total, records = self.episode(draws)
            if tracer is not None:
                tracer.finish()
            sync(self.device)
            self.batches.append((b, records, self.plans))
            totals.append(total)
            b += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        returns = torch.cat(totals).cpu().numpy()
        limit = tracer.start if tracer is not None else None
        host = [s2 - s1 for (b1, i1, s1), (b2, i2, s2) in zip(stamps, stamps[1:])
                if b1 == b2 and i1 >= 1 and (limit is None or b1 * self.ticks + i2 <= limit)]
        return Window(seconds=elapsed, work=b * self.S * self.cell.rollouts * self.ticks,
                      attempted=len(returns), failed=int(np.sum(~np.isfinite(returns))), host_tick_s=host)

    def judge(self, rng: np.random.Generator) -> dict:
        """The judge on one batch of the window and a sample of its seeds, drawn by ``rng``."""
        b, records, plans = self.batches[int(rng.integers(len(self.batches)))]
        sample = sorted(rng.choice(self.S, size=int(self.cell.traffic["check"]["seeds"]), replace=False).tolist())
        self.batches = []  # the other batches' state is freed before the reference runs
        draws = inputs.EpisodeDraws(self.cell, self.seed, b, self.device)
        plans = plans if torch.is_tensor(plans) else torch.stack(plans, dim=1)
        return check.follow_episodes(self.cell, self.params, draws, records, plans, sample, self.device)

    def control(self, rng: np.random.Generator) -> dict:
        """The control's numbers: the reference in TF32 and bfloat16 in the
        port's place on batch 0's inputs, judged as the port is."""
        draws = inputs.EpisodeDraws(self.cell, self.seed, 0, self.device)
        self.batches = [(0, *check.control_episodes(self.cell, self.params, draws, self.device))]
        return self.judge(rng)
