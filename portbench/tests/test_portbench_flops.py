"""The yardsticks against hand arithmetic."""

import pytest

from portbench import flops

CARTPOLE = {"n_obs": 5, "m_act": 1, "terms": 17, "actions": 4}


def by_hand(width):
    """The count written out: GRU layer 1 (input 1), layer 2 (input h), each
    over 4 steps at 2 FLOPs a product; the encoder h -> 2; the trunk
    41 -> width -> width -> 170; the combine 10 x 17 x 5."""
    h = width // 2
    gru = 2 * 4 * (1 * 3 * h + h * 3 * h) + 2 * 4 * (h * 3 * h + h * 3 * h)
    return gru + 2 * h * 2 + 2 * (41 * width + width * width + width * 170) + 850


@pytest.mark.parametrize("width, expect", [(128, 384_338), (512, 5_466_962)])
def test_flops_per_row(width, expect):
    got = flops.forward_flops_per_row(width=width, gru_hidden=width // 2, **CARTPOLE)
    assert got == by_hand(width) == expect


def test_width_128_is_bench_torch_count():
    # bench_torch.py's nl_forward_flops_analytic for cartpole at hidden 128
    assert flops.forward_flops_per_row(width=128, gru_hidden=64, **CARTPOLE) == 384_338


@pytest.mark.parametrize("width", [128, 512])
def test_bytes(width):
    h = width // 2
    weights = (1 * 3 * h + h * 3 * h + 6 * h) + (h * 3 * h + h * 3 * h + 6 * h) + (2 * h + 2) \
        + (41 * width + width) + (width * width + width) + (width * 170 + 170)
    rows = 20_000
    assert flops.forward_bytes(rows, width=width, gru_hidden=h, **CARTPOLE) == 4 * (rows * (5 + 4 + 5) + weights)


def test_least_time_is_compute_bound_at_20000_rows():
    dims = dict(width=128, gru_hidden=64, **CARTPOLE)
    least = flops.forward_least_seconds(20_000, **dims)
    assert least == pytest.approx(20_000 * 384_338 / 495e12)
    assert 15e-6 < least < 16e-6
