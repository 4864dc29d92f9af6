"""The yardsticks: the work of one NL forward and the chip's peaks.

The work is the algorithm's, counted from the model's dims, never from what a
kernel does to compute it: every product of a matrix multiplication is 2
FLOPs and is counted once, whatever passes a kernel makes to keep float32
accuracy; each input and weight byte is read once and each output byte
written once. ``forward_flops_per_row`` is ``bench_torch.py``'s analytic
count (``nl_forward_flops_analytic``) with the GRU's and the trunk's widths
taken apart.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, from NVIDIA's data sheet (at its 700 W limit)
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def forward_flops_per_row(n_obs: int, m_act: int, width: int, gru_hidden: int, terms: int,
                          actions: int, gru_layers: int = 2, latent: int = 2) -> int:
    """FLOPs of one NL forward on one row at one query time:

    - the reverse GRU over the ``actions``-step window, per layer and step
      x @ W_ih (in x 3h) and h @ W_hh (h x 3h);
    - the encoder's linear map h -> ``latent``;
    - the trunk (2 terms + n + latent) -> width -> width -> 2 terms n;
    - the fourier combine, ~10 FLOPs per (term, output dimension).

    Elementwise nonlinearities are left out (under 2% of the products).
    """
    h = gru_hidden
    flops, in_dim = 0, m_act
    for _ in range(gru_layers):
        flops += 2 * actions * (in_dim * 3 * h + h * 3 * h)
        in_dim = h
    flops += 2 * h * latent
    w_in = 2 * terms + n_obs + latent
    flops += 2 * (w_in * width + width * width + width * 2 * terms * n_obs)
    flops += 10 * terms * n_obs
    return flops


def forward_weight_count(n_obs: int, m_act: int, width: int, gru_hidden: int, terms: int,
                         gru_layers: int = 2, latent: int = 2) -> int:
    """The parameters one forward reads: the GRU's, the encoder's and the trunk's."""
    h, count, in_dim = gru_hidden, 0, m_act
    for _ in range(gru_layers):
        count += in_dim * 3 * h + h * 3 * h + 2 * 3 * h
        in_dim = h
    count += h * latent + latent
    w_in = 2 * terms + n_obs + latent
    count += w_in * width + width + width * width + width + width * 2 * terms * n_obs + 2 * terms * n_obs
    return count


def forward_bytes(rows: int, n_obs: int, m_act: int, width: int, gru_hidden: int, terms: int,
                  actions: int, gru_layers: int = 2, latent: int = 2) -> int:
    """Bytes one forward of ``rows`` rows moves at the least: the observations
    and action windows read, the weights read, the state differences written."""
    inputs = rows * (n_obs + actions * m_act)
    outputs = rows * n_obs
    weights = forward_weight_count(n_obs, m_act, width, gru_hidden, terms, gru_layers, latent)
    return F32_BYTES * (inputs + outputs + weights)


def forward_least_seconds(rows: int, **dims) -> float:
    """The least time a forward of ``rows`` rows can take on the chip: the
    larger of its FLOPs at the TF32 peak and its bytes at HBM bandwidth."""
    flops = rows * forward_flops_per_row(**dims)
    return max(flops / PEAK_TF32_FLOPS, forward_bytes(rows, **dims) / PEAK_HBM_BYTES_PER_S)
