"""The fused planner-path NL forward (port of ``ops/pallas_nl.py``).

The planner calls the NL model T times per tick at batch K with one shared
query horizon t. ``pack_nl_forward`` folds every normalization and the fixed
fourier contour into the weights on the host (the JAX module's host code,
unchanged), so the forward consumes RAW obs and action buffers:

    reverse GRU (2 layers, newest -> oldest over the A-long buffer)
    encoder linear -> action latent
    trunk MLP (2 tanh layers; obs normalization and contour in layer 1)
    theta/phi head + inverse stereographic map + fourier combine

``repack_nl_forward`` lays those operands out once more for the card, in one
flat float32 buffer (see ``forward_sections``), after ``pad_nl_forward`` has
zero-padded a ragged GRU width to a multiple of 8 and a ragged trunk width to
a multiple of 16. ``nl_forward_fused`` launches the CUDA kernels
(``csrc/nl_kernels.cu``) on that repack for CUDA tensors: ``nl_forward_kernel``
up to width 128 where that layout fits (from 11,000 rows, clusters of CTAs
that keep the weights in shared memory, split by stage, for the whole launch
while they walk row tiles; below, one 8-row tile a CTA), else the chain of
stage kernels named "streamed", which tiles each product over rows and
columns (``wide_layout`` picks the layout). For CPU tensors it computes ``nl_forward_plain``, the
same function in plain PyTorch on ``pack_nl_forward``'s operands. Both are the
implementations of one operator, ``torch.ops.nlc.nl_forward``
(``nl_forward_op``), so an exported planner step records the kernel as a
node of its graph. Each forward's host side is one span
(``utils.timing.span``) named by the route it takes: ``fwd.resident``,
``fwd.streamed`` or, on the CPU, ``fwd.plain``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.timing import span
from . import nl_cuda
from .ilt import fourier_spherical_host
from .pallas_ilt import (
    _host,
    _round_up,
    head_chunks,
    head_size,
    nl_head_plain,
    pack_head_weights,
    repack_head,
)

MMA_M, MMA_K = 16, 8  # mma.sync.m16n8k8: output columns per tile, inputs per step
_GROUP = 8  # GRU hidden units per warp: their r/z gates fill one 16-column tile
_LATENT = 2  # the encoder's action latent
_ROWS = 8  # batch rows of an n-tile of mma.m16n8k8 (kRows in csrc/nl_kernels.cu)
_BAR_FLOATS = 8  # the footprint's mbarrier floats (kBarFloats)
_CLUSTER_BAR_FLOATS = 16  # a resident CTA's mbarrier floats at kGruCtas = 2 (kClusterBarFloats)
_GRU_CTAS = 2  # GRU CTAs a cluster of the resident kernel (kGruCtas)
_SLOTS = 2  # ring slots for each GRU CTA in the trunk/head CTA (kSlots)
_TILE_ROWS = 16  # batch rows of the cluster walk's tiles (kTileRows)
_SMEM_BUDGET = 232448  # bytes: an H100 block's opt-in dynamic shared memory (kSmemBudget)
# zero floats that end the wide layout's buffer, so that its length tells it from the
# resident layout's at every width (kWideTag)
_WIDE_TAG = 4
ACTION_STEPS = 4  # the action buffer's steps a buffer is packed for unless told (Config's default)
_FORWARD_SPANS = {"resident": "fwd.resident", "streamed": "fwd.streamed"}  # by nl_cuda.forward_plan's variant


def gru_gates(gi, gh, h):
    """GRU gate nonlinearity (r/z/n blocks; the candidate's hidden path is
    gated by reset after the hidden matmul and its own bias): h' = (1 - z) n
    + z h, as n + z (h - n). The r and z gates share one add and one sigmoid,
    so a step is five elementwise launches."""
    H = h.shape[-1]
    rz = torch.sigmoid(gi[..., : 2 * H] + gh[..., : 2 * H])
    n = torch.tanh(torch.addcmul(gi[..., 2 * H :], rz[..., :H], gh[..., 2 * H :]))
    return torch.lerp(n, h, rz[..., H:])


def pack_nl_forward(
    params,
    t_model: float,
    state_dim: int,
    action_dim: int,
    terms: int,
    state_mean,
    state_std,
    action_mean,
    action_std,
    normalize: bool = True,
    encode_obs_time: bool = False,
):
    """Fold normalizations + the fixed contour into a flat tuple of float32
    numpy operands. ``t_model`` is the (already normalized + floored) query time.
    """
    gru = params["encoder"]["gru"]
    assert len(gru) == 2, "NL encoder is a 2-layer GRU (w_nl.py:21)"
    l1, l2 = gru
    w_ih1 = _host(l1["w_ih"]).copy()
    b_ih1 = _host(l1["b_ih"]).copy()

    # fold action normalization into layer-1 input weights. The age channel
    # (encode_obs_time) is un-normalized (models/nl.py _norm_actions).
    m = action_dim
    a_mean = np.zeros(m, np.float32) if not normalize else _host(action_mean)
    a_std = np.full(m, 3.0, np.float32) if not normalize else _host(action_std)
    a_mean = np.broadcast_to(a_mean, (m,))
    a_std = np.broadcast_to(a_std, (m,))
    # (a - mu)/sigma @ w == a @ (w/sigma) - mu @ (w/sigma): scale the rows,
    # then shift the bias with the SCALED weights
    w_ih1[:m, :] = w_ih1[:m, :] / a_std[:, None]
    b_ih1 = b_ih1 - a_mean @ w_ih1[:m, :]

    trunk = params["laplace_rep"]
    w1 = _host(trunk[0]["w"])
    b1 = _host(trunk[0]["b"]).copy()
    L = state_dim + 2  # laplace latent dim (w_nl.py:90)
    assert w1.shape[0] == 2 * terms + L

    # fourier contour s_k = sigma + i k pi / T at the shared query time
    theta_s, phi_s = fourier_spherical_host(float(t_model), terms)
    b1 = b1 + theta_s @ w1[:terms] + phi_s @ w1[terms : 2 * terms]

    w1_obs = w1[2 * terms : 2 * terms + state_dim].copy()
    w1_act = w1[2 * terms + state_dim :].copy()
    if normalize:
        s_mean = _host(state_mean)
        s_std = _host(state_std)
        b1 = b1 - (s_mean / s_std) @ w1_obs
        w1_obs = w1_obs / s_std[:, None]

    head = pack_head_weights(trunk[-1]["w"], trunk[-1]["b"], state_dim, terms, t_model)

    return (
        w_ih1, _host(l1["w_hh"]), b_ih1[None, :], _host(l1["b_hh"])[None, :],
        _host(l2["w_ih"]), _host(l2["w_hh"]), _host(l2["b_ih"])[None, :], _host(l2["b_hh"])[None, :],
        _host(params["encoder"]["out"]["w"]), _host(params["encoder"]["out"]["b"])[None, :],
        w1_obs, w1_act, b1[None, :],
        _host(trunk[1]["w"]), _host(trunk[1]["b"])[None, :],
    ) + head


def nl_trunk_plain(obs, acts_flat, packed, in_dim: int):
    """The GRU, encoder and trunk of ``nl_forward_plain``: the head's input [B, hid]."""
    (
        w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
        w_enc, b_enc, w1_obs, w1_act, b1, w2, b2,
    ) = packed[:15]
    B = obs.shape[0]
    A = acts_flat.shape[1] // in_dim
    H = w_hh1.shape[0]
    h1 = obs.new_zeros((B, H))
    h2 = obs.new_zeros((B, H))
    # flipped buffer: consume newest -> oldest (w_nl.py:27)
    for step in range(A):
        src = A - 1 - step
        x_t = acts_flat[:, src * in_dim : (src + 1) * in_dim]
        h1 = gru_gates(x_t @ w_ih1 + b_ih1, h1 @ w_hh1 + b_hh1, h1)
        h2 = gru_gates(h1 @ w_ih2 + b_ih2, h2 @ w_hh2 + b_hh2, h2)
    p_act = h2 @ w_enc + b_enc
    hid = torch.tanh(obs @ w1_obs + p_act @ w1_act + b1)
    return torch.tanh(hid @ w2 + b2)


def nl_forward_plain(obs, acts_flat, packed, state_dim: int, in_dim: int):
    """The forward kernel's function in plain PyTorch, on the same packed operands."""
    return nl_head_plain(nl_trunk_plain(obs, acts_flat, packed, in_dim), packed[15:], state_dim)


def _frag_index(K: int, M: int):
    """Row and column of ``W`` [K, M] at each slot of the fragment layout.

    The layout is [M/16 tiles][K/8 steps][32 lanes][4], the A operand of
    ``mma.sync.m16n8k8.tf32`` with the weights' output columns as its M side:
    lane l holds (m, k) = (g + 8 (j & 1), c + 4 (j >> 1)) of its tile and step
    in register j, where g = l // 4 and c = l % 4. One 16-byte load per lane
    fetches a lane's four registers.
    """
    lane = np.arange(32)
    j = np.arange(4)
    m = (lane[:, None] >> 2) + 8 * (j[None, :] & 1)
    k = (lane[:, None] & 3) + 4 * (j[None, :] >> 1)
    mt = np.arange(_round_up(M, MMA_M) // MMA_M)[:, None, None, None]
    kt = np.arange(_round_up(K, MMA_K) // MMA_K)[None, :, None, None]
    return np.broadcast_arrays(kt * MMA_K + k, mt * MMA_M + m)


def frag_pack(w) -> np.ndarray:
    """``W`` [K, M] -> flat fragment layout (zero-padded to K % 8 == M % 16 == 0)."""
    w = _host(w)
    K, M = w.shape
    padded = np.zeros((_round_up(K, MMA_K), _round_up(M, MMA_M)), np.float32)
    padded[:K, :M] = w
    rows, cols = _frag_index(K, M)
    return padded[rows, cols].reshape(-1)


def padded_widths(H: int, hid: int) -> tuple[int, int]:
    """The GRU width and the trunk width as the kernels lay them out: H up to
    a multiple of 8 (a warp's group of units), hid up to a multiple of 16 (the
    MMA's M)."""
    return _round_up(H, _GROUP), _round_up(hid, MMA_M)


def _pad_gates(w, H: int, Hp: int):
    """[..., 3H] -> [..., 3Hp]: each of the r, z, n blocks zero-padded to Hp."""
    out = np.zeros(w.shape[:-1] + (3 * Hp,), w.dtype)
    for g in range(3):
        out[..., g * Hp : g * Hp + H] = w[..., g * H : (g + 1) * H]
    return out


def _pad_to(w, shape):
    out = np.zeros(shape, w.dtype)
    out[tuple(slice(0, k) for k in w.shape)] = w
    return out


def pad_nl_forward(packed):
    """``pack_nl_forward``'s operands (numpy, any float dtype, kept) with the
    GRU width padded to a multiple of 8 and the trunk width to a multiple of
    16 by zeros. The forward is unchanged, exactly: a padded GRU unit has
    zero weights and biases, so its gates are r = z = 1/2 and n = 0 and it
    stays at h = 0 from h_0 = 0, and its rows in the next layer, the encoder
    and the trunk are zero; a padded trunk column is tanh(0) = 0, and its
    head rows are zero."""
    (
        w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
        w_enc, b_enc, w1_obs, w1_act, b1, w2, b2,
    ) = (np.asarray(x) for x in packed[:15])
    H, hid = w_hh1.shape[0], w2.shape[0]
    Hp, hidp = padded_widths(H, hid)
    gates = [_pad_gates(w, H, Hp) for w in (w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2)]
    for i in (1, 4, 5):  # the hidden-state rows
        gates[i] = _pad_to(gates[i], (Hp, 3 * Hp))
    head = [np.asarray(x) for x in packed[15:]]
    head[0], head[1] = (_pad_to(w, (hidp, w.shape[1])) for w in head[:2])
    return tuple(gates) + (
        _pad_to(w_enc, (Hp, w_enc.shape[1])), b_enc,
        _pad_to(w1_obs, (w1_obs.shape[0], hidp)), _pad_to(w1_act, (w1_act.shape[0], hidp)), _pad_to(b1, (1, hidp)),
        _pad_to(w2, (hidp, hidp)), _pad_to(b2, (1, hidp)),
    ) + tuple(head)


def resident_bytes(n: int, A: int, in_dim: int, H: int, hid: int, D: int, terms: int) -> int:
    """Dynamic shared memory of the resident kernel's one-tile walk at these
    dims, the widths padded as ``padded_widths`` pads them: a CTA that holds
    one 8-row tile's activations and, in turn, GRU layer 1 then trunk layer
    2 and GRU layer 2 then the head's chunks (``footprint`` in
    csrc/nl_kernels.cu). The host packs the resident layout where it fits
    (``wide_layout``); the library runs the cluster walk there where both of
    its roles fit (``tile_bytes``), else this one."""
    H, hid = padded_widths(H, hid)
    kx, k1 = _round_up(in_dim, MMA_K), _round_up(n + _LATENT, MMA_K)
    chunks, mc = head_chunks(hid, D, terms)
    small = 12 * H + _LATENT * H + 4 + k1 * hid + 2 * hid
    gru1, gru2 = (H // _GROUP) * (kx + H) * 24, (H // _GROUP) * 2 * H * 24
    acts = 2 * _ROWS * (A * (kx + 4) + 4 * (H + 4) + (k1 + 4) + (hid + 4)) + _ROWS * (hid + 4 + chunks * mc + 4)
    return 4 * (_BAR_FLOATS + small + max(gru1, hid * hid) + max(gru2, mc * (4 + 2 * hid)) + acts)


def tile_bytes(n: int, A: int, in_dim: int, H: int, hid: int, D: int, terms: int) -> dict:
    """Dynamic shared memory of each role of the resident kernel's cluster
    walk (``tile_layout`` in csrc/nl_kernels.cu: 16 rows a tile), the widths
    padded as ``padded_widths`` pads them: ``gru``, a GRU CTA
    (the small operands, both GRU layers, the tile's action steps and five
    split GRU states); ``trunk_head``, the trunk/head CTA (the ring of
    latents, the small operands, trunk layer 2, the head or one chunk of
    it, the tile's trunk activations); ``head_resident``, whether the whole
    head fits there. A launch takes the larger of the two."""
    H, hid = padded_widths(H, hid)
    kx, k1 = _round_up(in_dim, MMA_K), _round_up(n + _LATENT, MMA_K)
    chunks, mc = head_chunks(hid, D, terms)
    rows = _TILE_ROWS
    small = 12 * H + _LATENT * H + 4 + k1 * hid + 2 * hid
    gru = _CLUSTER_BAR_FLOATS + small + (H // _GROUP) * (kx + 3 * H) * 24 + 2 * rows * (
        A * (kx + 4) + 5 * (H + 4))
    chunk = mc * (4 + 2 * hid)
    base = _CLUSTER_BAR_FLOATS + _GRU_CTAS * _SLOTS * rows * _LATENT + small + hid * hid
    acts = 2 * rows * (k1 + 4) + 4 * rows * (hid + 4) + rows * (chunks * mc + 4)
    head_resident = 4 * (base + chunks * chunk + acts) <= _SMEM_BUDGET
    return {"gru": 4 * gru, "trunk_head": 4 * (base + (chunks if head_resident else 1) * chunk + acts),
            "head_resident": head_resident}


def wide_layout(n: int, in_dim: int, H: int, hid: int, D: int, terms: int, actions: int = ACTION_STEPS) -> bool:
    """Whether a model at these dims takes the wide layout (the streamed
    variant's), for a forward over ``actions`` action steps: past H = 64
    padded, width 128, where the resident kernel's GRU groups (8 warps of 8
    units a layer) end, and wherever the resident layout needs more shared
    memory than a block has (``resident_bytes``; a wide head or a long
    action buffer). The kernel library's plan makes the same test
    (``forward_plan`` in ``csrc/nl_kernels.cu``) and tells the layouts
    apart by the buffer's length."""
    return (_round_up(H, _GROUP) > 8 * _GROUP
            or resident_bytes(n, actions, in_dim, H, hid, D, terms) > _SMEM_BUDGET)


def forward_sections(n: int, in_dim: int, H: int, hid: int, D: int, terms: int,
                     actions: int = ACTION_STEPS) -> dict:
    """float32 counts of ``repack_nl_forward``'s sections, in buffer order,
    for a model of GRU width H and trunk width hid (padded here as
    ``padded_widths`` pads them), packed for ``actions`` action steps.

    - ``small``: b_ih1, b_hh1, b_ih2, b_hh2 [3H each], w_enc [H, 2],
      b_enc [2, padded to 4], W1 = [w1_obs; w1_act] in fragments, b1, b2.
    - ``gru1`` / ``gru2``: one GRU layer over [x; h] (x = the layer's input,
      padded to 8). The resident layout (``_gru_tiles``): for each group of
      8 hidden units, the r/z tile and the candidate's half tiles. The wide
      layout (``wide_layout``, ``_gru_wide_tiles``): for each m-tile of 16
      units, each k-step, the r, z and candidate fragments.
    - ``w2``: the second trunk layer in fragments.
    - ``head``: ``repack_head``'s buffer.
    - ``tag``, in the wide layout only: ``_WIDE_TAG`` zeros.

    The resident kernel's one-tile walk copies small+gru1 and gru2 at its
    start, w2 into gru1's place once the first GRU layer is done, and the
    head's chunks in turn into gru2's place once the second is. In its
    cluster walk a GRU CTA copies small+gru1 and gru2 once a launch, the
    trunk/head CTA small, then w2 with the head (or w2, and the head's
    chunks in turn for every tile where the whole head does not fit beside
    it). The streamed variant's stage
    kernels read the products' fragments in tiles of 4 m-tiles by 4 k-steps,
    the biases, the encoder, W1 and the head from global memory.
    """
    H, hid = padded_widths(H, hid)
    kx = _round_up(in_dim, MMA_K)
    k1 = _round_up(n + _LATENT, MMA_K)
    wide = wide_layout(n, in_dim, H, hid, D, terms, actions)
    if wide:
        gru = [3 * _round_up(H, MMA_M) * (k + H) for k in (kx, H)]
    else:
        gru = [(H // _GROUP) * (k + H) * 24 for k in (kx, H)]
    return {
        "small": 12 * H + _LATENT * H + 4 + k1 * hid + 2 * hid,
        "gru1": gru[0],
        "gru2": gru[1],
        "w2": hid * hid,
        "head": head_size(hid, D, terms),
    } | ({"tag": _WIDE_TAG} if wide else {})


def _gru_tiles(w_ih, w_hh) -> np.ndarray:
    """One GRU layer's weights in the resident kernel's per-group tile order."""
    kin, G = w_ih.shape
    H = G // 3
    kx = _round_up(kin, MMA_K)
    ks = (kx + H) // MMA_K
    cat = np.zeros((kx + H, G), np.float32)
    cat[:kin] = w_ih
    cat[kx:] = w_hh
    out = []
    for g in range(H // _GROUP):
        u = g * _GROUP + np.arange(_GROUP)
        cand = np.zeros((kx + H, MMA_M), np.float32)
        cand[:kx, :_GROUP] = cat[:kx, 2 * H + u]
        cand[kx:, _GROUP:] = cat[kx:, 2 * H + u]
        frags = frag_pack(cand).reshape(ks, 32, 4)
        half = np.concatenate([frags[: kx // MMA_K][..., [0, 2]], frags[kx // MMA_K :][..., [1, 3]]])
        out += [frag_pack(cat[:, np.concatenate([u, H + u])]), half.reshape(-1)]
    return np.concatenate(out)


def _gru_wide_tiles(w_ih, w_hh) -> np.ndarray:
    """One GRU layer's weights in the wide order, [H/16 m-tiles][k-steps of
    [x; h]][r, z, n][32 lanes][4]: each gate's [x; h] x H matrix in
    fragments, the three side by side per k-step, so that a stage kernel
    brings a tile's k-steps of all three gates in one copy. The candidate's
    column is w_ih's on x's k-steps and w_hh's on h's; the kernel sums the
    two apart. H (a multiple of 8) is padded to 16 by zero columns."""
    kin, G = w_ih.shape
    H = G // 3
    kx = _round_up(kin, MMA_K)
    cat = np.zeros((kx + H, G), np.float32)
    cat[:kin] = w_ih
    cat[kx:] = w_hh
    mt, ks = _round_up(H, MMA_M) // MMA_M, (kx + H) // MMA_K
    gates = [frag_pack(cat[:, g * H : (g + 1) * H]).reshape(mt, ks, 1, 128) for g in range(3)]
    return np.concatenate(gates, axis=2).reshape(-1)


def repack_nl_forward(packed, state_dim: int, in_dim: int, terms: int, actions: int = ACTION_STEPS) -> np.ndarray:
    """``pack_nl_forward``'s operands -> the forward kernels' flat float32
    buffer (sections as ``forward_sections`` lists them, the GRU's in the
    layout ``wide_layout`` picks for ``actions`` action steps), at the
    widths ``pad_nl_forward`` pads them to. Host numpy, once per
    controller."""
    packed = pad_nl_forward([_host(p) for p in packed])
    (
        w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
        w_enc, b_enc, w1_obs, w1_act, b1, w2, b2,
    ) = packed[:15]
    H, hid = w_hh1.shape[0], w2.shape[0]
    if w_ih1.shape[0] != in_dim or w_enc.shape[1] != _LATENT:
        raise ValueError(f"unsupported shapes: w_ih1 {w_ih1.shape}, in_dim={in_dim}, w_enc {w_enc.shape}")
    w1 = np.concatenate([w1_obs, w1_act])
    wide = wide_layout(state_dim, in_dim, H, hid, state_dim, terms, actions)
    tiles = _gru_wide_tiles if wide else _gru_tiles
    small = [b_ih1, b_hh1, b_ih2, b_hh2, w_enc, np.pad(b_enc.reshape(-1), (0, 2)),
             frag_pack(w1), b1, b2]
    buf = np.concatenate(
        [np.concatenate([x.reshape(-1) for x in small]), tiles(w_ih1, w_hh1),
         tiles(w_ih2, w_hh2), frag_pack(w2), repack_head(packed[15:], state_dim, terms),
         np.zeros(_WIDE_TAG if wide else 0, np.float32)]
    )
    assert buf.size == sum(forward_sections(state_dim, in_dim, H, hid, state_dim, terms, actions).values())
    return buf


def _nl_forward_cuda(obs, acts_flat, packed, hopper, state_dim: int, in_dim: int, terms: int):
    """The forward kernel's launch: the operator's CUDA implementation. The
    kernel library picks the variant from the dims (``nl_cuda.forward_plan``);
    dims that neither variant takes raise before anything is launched. The
    streamed variant's chain keeps its activations in scratch allocated
    here, on the caching allocator."""
    if hopper is None:
        raise ValueError("the forward kernel reads the repacked weights: pass hopper=repack_nl_forward(...)")
    B, n = obs.shape
    if acts_flat.shape[0] != B or acts_flat.shape[1] % in_dim:
        raise ValueError(f"acts_flat {tuple(acts_flat.shape)} does not match obs rows {B} x in_dim {in_dim}")
    A = acts_flat.shape[1] // in_dim
    H, hid = packed[1].shape[0], packed[13].shape[0]
    dims = (B, n, A, in_dim, H, hid, state_dim, terms, hopper.numel())
    plan = nl_cuda.forward_plan(dims)
    with span(_FORWARD_SPANS[plan["variant"]]):
        out = torch.empty((B, state_dim), dtype=torch.float32, device=obs.device)
        operands = (obs, acts_flat, hopper, out)
        if plan["variant"] == "streamed":
            operands += (torch.empty(plan["scratch_floats"], dtype=torch.float32, device=obs.device),)
        nl_cuda.launch("nl_forward_launch", operands, dims)
        nl_forward_fused.launches += 1
        nl_forward_fused.rows += B
        nl_forward_fused.weight_loads += plan["ctas"]
        if plan["variant"] == "streamed":
            nl_forward_fused.streamed_launches += 1
            nl_forward_fused.streamed_rows += B
        return out


def _nl_forward_cpu(obs, acts_flat, packed, hopper, state_dim: int, in_dim: int, terms: int):
    """The operator's CPU implementation: the plain forward (``hopper`` unread)."""
    with span("fwd.plain"):
        return nl_forward_plain(obs, acts_flat, packed, state_dim, in_dim).contiguous()


@torch.library.custom_op("nlc::nl_forward", mutates_args=(), device_types="cpu")
def nl_forward_op(obs: torch.Tensor, acts_flat: torch.Tensor, packed: list[torch.Tensor],
                  hopper: Optional[torch.Tensor], state_dim: int, in_dim: int, terms: int) -> torch.Tensor:
    """``torch.ops.nlc.nl_forward``: the forward kernel as a PyTorch operator,
    which ``torch.export`` records as one node. CUDA tensors launch the
    kernel, CPU tensors compute the plain forward."""
    return _nl_forward_cpu(obs, acts_flat, packed, hopper, state_dim, in_dim, terms)


nl_forward_op.register_kernel("cuda")(_nl_forward_cuda)


@nl_forward_op.register_fake
def _nl_forward_fake(obs, acts_flat, packed, hopper, state_dim, in_dim, terms):
    return obs.new_empty((obs.shape[0], state_dim))


def nl_forward_fused(obs, acts_flat, packed, state_dim: int, in_dim: int, *, terms: int, hopper=None):
    """Raw obs [B, n] + raw flattened action buffer [B, A*in] -> state
    difference [B, state_dim] through the forward kernel.

    ``terms`` is the count of live fourier terms in each padded head block
    (see ``pallas_ilt.nl_head_fused``). On CPU tensors this computes
    ``nl_forward_plain`` on ``packed``. On CUDA tensors the kernel reads
    ``hopper``, ``repack_nl_forward(packed, state_dim, in_dim, terms, A)``
    as a tensor on the same device.

    Under tracing (``torch.export``) this is a call of the operator
    ``nl_forward_op``. Eager calls run the operator's implementation for
    the tensors' device directly, which spares the dispatcher's ~20 us a
    call on the planner's 40 launches a tick; the kernel and its count
    are the same either way.
    """
    if type(obs) is not torch.Tensor or torch.compiler.is_compiling():
        return nl_forward_op(obs, acts_flat, list(packed), hopper, state_dim, in_dim, terms)
    impl = _nl_forward_cpu if obs.device.type == "cpu" else _nl_forward_cuda
    return impl(obs, acts_flat, packed, hopper, state_dim, in_dim, terms)


nl_forward_fused.launches = 0  # forwards launched since the last reset, the exported program's included
nl_forward_fused.rows = 0  # batch rows over those launches
nl_forward_fused.streamed_launches = 0  # of those, the streamed variant's (2 A + 4 device launches each)
nl_forward_fused.streamed_rows = 0
# the resident launches' CTA weight loads (each CTA copies its part of the weights once a launch):
# (rows - streamed_rows) / weight_loads is the rows each load serves
nl_forward_fused.weight_loads = 0
