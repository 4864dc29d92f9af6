"""The draws the benchmark makes are a function of the seed."""

import pytest
import torch

from portbench import cell as cells
from portbench import inputs
from portbench.seeds import stream_seed

torch.set_num_threads(1)
SMALL = {"seeds": 3, "rollouts": 16, "horizon": 6}


def draw(cell, seed, batch):
    d = inputs.EpisodeDraws(cell, seed, batch, "cpu")
    return [d.reset_state(), d.plan0(), d.planner_noise(0), d.planner_noise(1), d.dt(0, "fixed", 0.05)]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 17])
def test_episode_draws_repeat_by_seed(seed):
    cell = cells.load("nl128-eval-s20", traffic_overrides=SMALL)
    a, b = draw(cell, seed, 3), draw(cell, seed, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = draw(cell, seed + 1, 3)
    assert not torch.equal(a[2], other[2])
    assert not torch.equal(a[2], draw(cell, seed, 4)[2])  # each batch its own draws


def test_episode_draws_shapes_and_box():
    cell = cells.load("nl128-eval-s20", traffic_overrides=SMALL)
    raw, U, noise, noise1, dt = draw(cell, 11, 0)
    assert raw.shape == (3, 4) and U.shape == (3, 6, 1) and noise.shape == (3, 16, 6, 1) and dt.shape == (3,)
    center = torch.tensor(cell.traffic["initial_state"]["center"])
    assert torch.all(torch.abs(raw - center) <= 0.05)
    assert torch.all(dt == 0.05)


def test_plant_draws_repeat_by_seed():
    cell = cells.load("nl128-serve-k32768", traffic_overrides={"rollouts": 16, "horizon": 6})
    a, b = inputs.PlantDraws(cell, 9, 2, "cpu"), inputs.PlantDraws(cell, 9, 2, "cpu")
    assert torch.equal(a.raw0, b.raw0) and torch.equal(a.U0, b.U0)
    assert torch.equal(a.noise(), b.noise()) and torch.equal(a.noise(), b.noise())
    c = inputs.PlantDraws(cell, 9, 3, "cpu")
    assert not torch.equal(a.U0, c.U0)


def test_stream_seeds_fit_a_generator_and_differ():
    seeds = {stream_seed(s, "batch", b) for s in (0, 1, 2**33) for b in range(4)}
    assert len(seeds) == 12 and all(0 <= s < 2**63 for s in seeds)
