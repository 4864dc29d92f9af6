"""On the card: the control (the reference in TF32 and bfloat16 in the port's
place) fails a cell's limits, and the port passes them, at sizes a test run
can hold: each cell's own rows a forward, fewer seeds and ticks.

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import calibrate, check
from portbench import cell as cells

SMALL = {
    "nl128-eval-s20": {"seeds": 4, "episode_ticks": 40, "check": {"seeds": 2, "all_seed_ticks": 5}},
    "nl512-eval-s10": {"seeds": 2, "episode_ticks": 60, "check": {"seeds": 2, "all_seed_ticks": 5}},
    "nl128-serve-k32768": {"episode_ticks": 40},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_and_port_passes(card, name):
    limits = cells.load(name).limits
    r = calibrate.readings(name, [1_000_003], [2_000_003, 2_000_004, 2_000_005], traffic_overrides=SMALL[name])
    for seed, numbers in r["control"].items():
        assert not check.verdict(numbers, limits), (seed, numbers, limits)
    for seed, numbers in r["port"].items():
        assert check.verdict(numbers, limits), (seed, numbers, limits)
