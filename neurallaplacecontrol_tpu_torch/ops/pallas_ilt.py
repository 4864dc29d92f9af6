"""The fused NL head: hidden [B, H] -> state difference [B, D] (port of ``ops/pallas_ilt.py``).

    G_theta = x @ W_theta + b_theta;   G_phi = x @ W_phi + b_phi
    theta   = tanh(G_theta) * pi;      phi   = clip(tanh(G_phi) * pi/2)
    F       = r(phi) e^{i theta}       (per-hemisphere radius, ops.sphere)
    out     = F_re @ S_re - F_im @ S_im

``pack_head_weights`` lays the final linear layer out in padded theta/phi
blocks (column d*Tp + t) and builds the selection matrices S_re/S_im that
carry the per-term fourier weights and the e^{sigma t}/T prefactor; it is
the JAX module's host code, unchanged. ``repack_head`` lays those operands
out once more for the card: only the live columns, theta and phi weights
interleaved, and a compact pair of combine weights in place of the
selection matrices, in chunks that the kernel's shared memory holds one at
a time; a hidden width that is not a multiple of 4 gets zero rows up to the
next one. ``nl_head_fused``
launches the CUDA kernel ``nl_head_kernel`` (``csrc/nl_kernels.cu``) on that
repack for a CUDA tensor and computes ``nl_head_plain``, the same function
in plain PyTorch on ``pack_head_weights``'s operands, for a CPU tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import nl_cuda
from .ilt import _FOURIER_ALPHA, _FOURIER_EPS, _FOURIER_SCALE
from .sphere import _PHI_MARGIN

_LANE = 128
_T_PAD = 32  # terms padded to a divisor of the lane count
_COL_ALIGN = 4  # head columns (and its input rows) padded to 16 bytes, the bulk copy's granule
# floats of one head chunk in shared memory: 104 columns at Hx = 128 (csrc/nl_kernels.cu
# kHeadStageFloats); a wider Hx takes fewer columns a chunk
_HEAD_STAGE_FLOATS = 104 * (4 + 2 * 128)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _host(x) -> np.ndarray:
    """float32 numpy copy of a tensor or array, wherever it lives."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def fourier_weights(t: float, terms: int, dtype=np.float32):
    """Per-term combine weights and prefactor for a scalar query time."""
    T = _FOURIER_SCALE * t
    sigma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / T
    k = np.arange(terms)
    phase = np.pi * k * (t / T)
    half = np.where(k == 0, 0.5, 1.0)
    w_re = (half * np.cos(phase)).astype(dtype)
    w_im = (half * np.sin(phase)).astype(dtype)
    prefac = dtype(math.exp(sigma * t) / T)
    return w_re, w_im, prefac


def pack_head_weights(w, b, state_dim: int, terms: int, t: float):
    """Re-layout the final linear layer [H, 2*D*terms] (+bias) into padded
    theta/phi blocks and build the fourier selection matrices for query time
    ``t``. Returns float32 numpy (w_theta, w_phi, b_theta, b_phi, s_re, s_im).

    Original column layout (models/nl.py rep_fn reshape): col = d*terms + t
    for theta rows d < D, and (D + d)*terms + t for phi.
    """
    w = _host(w)
    b = _host(b)
    H = w.shape[0]
    D = state_dim
    Tp = _T_PAD if terms <= _T_PAD else _round_up(terms, _T_PAD)
    Dp = _LANE
    N = D * Tp

    w_theta = np.zeros((H, N), np.float32)
    w_phi = np.zeros((H, N), np.float32)
    b_theta = np.zeros((N,), np.float32)
    b_phi = np.zeros((N,), np.float32)
    for d in range(D):
        src_t = slice(d * terms, (d + 1) * terms)
        src_p = slice((D + d) * terms, (D + d + 1) * terms)
        dst = slice(d * Tp, d * Tp + terms)
        w_theta[:, dst] = w[:, src_t]
        w_phi[:, dst] = w[:, src_p]
        b_theta[dst] = b[src_t]
        b_phi[dst] = b[src_p]

    w_re, w_im, prefac = fourier_weights(float(t), terms)
    s_re = np.zeros((N, Dp), np.float32)
    s_im = np.zeros((N, Dp), np.float32)
    for d in range(D):
        s_re[d * Tp : d * Tp + terms, d] = w_re * prefac
        s_im[d * Tp : d * Tp + terms, d] = w_im * prefac
    return w_theta, w_phi, b_theta, b_phi, s_re, s_im


def head_chunks(hx: int, state_dim: int, terms: int) -> tuple[int, int]:
    """(chunks, columns per chunk) of ``repack_head``'s buffer for a head
    input of width ``hx``: the D*terms live columns split evenly into chunks
    of at most ``_HEAD_STAGE_FLOATS`` floats (4 vectors and the [Hx, Mc, 2]
    weights, Hx padded to a multiple of 4), each padded to a multiple of 4
    columns; at least 4 columns a chunk."""
    hx = _round_up(hx, _COL_ALIGN)
    cap = max(_COL_ALIGN, _HEAD_STAGE_FLOATS // (4 + 2 * hx) // _COL_ALIGN * _COL_ALIGN)
    ncols = state_dim * terms
    chunks = -(-ncols // cap)
    return chunks, _round_up(-(-ncols // chunks), _COL_ALIGN)


def head_size(hx: int, state_dim: int, terms: int) -> int:
    """float32 count of ``repack_head``'s buffer."""
    chunks, mc = head_chunks(hx, state_dim, terms)
    return chunks * mc * (4 + 2 * _round_up(hx, _COL_ALIGN))


def repack_head(packed, state_dim: int, terms: int) -> np.ndarray:
    """``pack_head_weights``'s operands -> one flat float32 buffer for the card,
    over the live columns j = d*terms + t only, in ``head_chunks`` chunks of
    Mc columns each (zero-padded):

        b_theta [Mc] | b_phi [Mc] | c_re [Mc] | c_im [Mc] | W [Hp, Mc, 2]

    with Hp the input width H rounded up to a multiple of 4 (zero rows).

    W interleaves W_theta and W_phi, so one 8-byte load brings both weights
    of a column. c_re/c_im hold the per-term combine weights (with the
    e^{sigma t}/T prefactor) that ``s_re``/``s_im`` carry on their diagonal
    blocks.
    """
    w_theta, w_phi, b_theta, b_phi, s_re, s_im = (_host(p) for p in packed)
    N = w_theta.shape[1]
    Tp = N // state_dim
    if not 0 < terms <= Tp or N != state_dim * Tp:
        raise ValueError(f"terms={terms} does not fit blocks of {Tp} in {N} columns")
    d = np.repeat(np.arange(state_dim), terms)
    live = d * Tp + np.tile(np.arange(terms), state_dim)
    hx = w_theta.shape[0]
    chunks, mc = head_chunks(hx, state_dim, terms)
    cols = np.zeros((4 + 2 * _round_up(hx, _COL_ALIGN), chunks * mc), np.float32)  # a column per row
    cols[:4, : live.size] = (b_theta.reshape(-1)[live], b_phi.reshape(-1)[live], s_re[live, d], s_im[live, d])
    cols[4 : 4 + 2 * hx : 2, : live.size] = w_theta[:, live]
    cols[5 : 5 + 2 * hx : 2, : live.size] = w_phi[:, live]
    parts = []
    for c in range(chunks):
        part = cols[:, c * mc : (c + 1) * mc]
        w = part[4:].reshape(-1, 2, mc).transpose(0, 2, 1)  # [H, Mc, 2]
        parts += [part[:4].reshape(-1), w.reshape(-1)]
    return np.concatenate(parts)


def to_device(packed, device) -> tuple:
    """Packed numpy operands -> contiguous float32 tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device).contiguous() for x in packed)


def _sphere_f(g_theta, g_phi):
    """theta/phi pre-activations -> (F_re, F_im) with the per-hemisphere radius."""
    theta = torch.tanh(g_theta) * math.pi
    half_pi = math.pi / 2.0
    phi = torch.clamp(torch.tanh(g_phi) * half_pi, -half_pi + _PHI_MARGIN, half_pi - _PHI_MARGIN)
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    north = phi >= 0.0
    r = torch.where(north, 1.0 + sin_phi, cos_phi) / torch.where(north, cos_phi, 1.0 - sin_phi)
    return r * torch.cos(theta), r * torch.sin(theta)


def nl_head_plain(x, packed, state_dim: int):
    """The head kernel's function in plain PyTorch, on the same packed operands."""
    w_theta, w_phi, b_theta, b_phi, s_re, s_im = packed
    f_re, f_im = _sphere_f(x @ w_theta + b_theta, x @ w_phi + b_phi)
    return (f_re @ s_re - f_im @ s_im)[:, :state_dim]


def _nl_head_cuda(x, packed, hopper, state_dim: int, terms: int):
    """The head kernel's launch: the operator's CUDA implementation."""
    if hopper is None:
        raise ValueError("the head kernel reads the repacked weights: pass hopper=repack_head(...)")
    B, Hx = x.shape
    out = torch.empty((B, state_dim), dtype=torch.float32, device=x.device)
    nl_cuda.launch("nl_head_launch", (x, hopper, out), (B, Hx, state_dim, terms, hopper.numel()))
    nl_head_fused.launches += 1
    return out


def _nl_head_cpu(x, packed, hopper, state_dim: int, terms: int):
    """The operator's CPU implementation: the plain head (``hopper`` unread)."""
    return nl_head_plain(x, packed, state_dim).contiguous()


@torch.library.custom_op("nlc::nl_head", mutates_args=(), device_types="cpu")
def nl_head_op(x: torch.Tensor, packed: list[torch.Tensor], hopper: Optional[torch.Tensor], state_dim: int,
               terms: int) -> torch.Tensor:
    """``torch.ops.nlc.nl_head``: the head kernel as a PyTorch operator. CUDA
    tensors launch the kernel, CPU tensors compute the plain head."""
    return _nl_head_cpu(x, packed, hopper, state_dim, terms)


nl_head_op.register_kernel("cuda")(_nl_head_cuda)


@nl_head_op.register_fake
def _nl_head_fake(x, packed, hopper, state_dim, terms):
    return x.new_empty((x.shape[0], state_dim))


def nl_head_fused(x, packed, state_dim: int, *, terms: int, hopper=None):
    """x [B, H] -> state difference [B, state_dim] through the head kernel.

    ``terms`` is the count of live fourier terms in each padded block of
    ``packed``. On a CPU tensor this computes ``nl_head_plain``. On a CUDA
    tensor the kernel reads ``hopper``, ``repack_head(packed, state_dim,
    terms)`` as a tensor on the same device. Traced, this is a call of the
    operator ``nl_head_op``; eager, of its implementation for the tensor's
    device (as ``pallas_nl.nl_forward_fused``).
    """
    if type(x) is not torch.Tensor or torch.compiler.is_compiling():
        return nl_head_op(x, list(packed), hopper, state_dim, terms)
    impl = _nl_head_cpu if x.device.type == "cpu" else _nl_head_cuda
    return impl(x, packed, hopper, state_dim, terms)


nl_head_fused.launches = 0  # kernel launches since the last reset
