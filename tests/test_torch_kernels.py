"""The port's kernel modules (ops.pallas_nl, ops.pallas_ilt, ops.nl_cuda).

On the CPU each wrapper computes its kernel's plain PyTorch version; those
are held against the JAX Pallas kernels run in interpret mode (as
tests/test_pallas_nl.py runs them) and against the port's unfused apply,
with the relative metric |got - exp| / (1 + |exp|) < 1e-2 of
tests/test_pallas_nl.py. The kernels' own layout (``repack_nl_forward``,
``repack_head``) is checked to lose nothing by unpacking it here, and the
forward is evaluated here on that layout as the kernel computes it, with the
split-TF32 products the kernels run on the tensor cores emulated, to show
their error against the 1e-3 limit (KERNEL_TOL) that tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernels to on a GPU.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.base import norm_stats_for
from neurallaplacecontrol_tpu.ops import pallas_ilt as jilt
from neurallaplacecontrol_tpu.ops import pallas_nl as jnl
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.ops import nl_cuda
from neurallaplacecontrol_tpu_torch.ops import pallas_ilt as tilt
from neurallaplacecontrol_tpu_torch.ops import pallas_nl as tnl
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params, load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV_DIMS = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
TOL = 1e-2
KERNEL_TOL = 1e-3
DT = 0.05


def rel_err(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (1.0 + np.abs(exp))).max())


def trained(env, delay=1):
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env, delay, "exp", 0, True)
    return load_pytree(path, device="cpu")


def draw(env, B, seed=3, in_extra=0):
    """obs ~ N(0, 1) and actions ~ U(-high, high), as tests/test_pallas_nl.py draws them."""
    n, m, high = ENV_DIMS[env]
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, n)).astype(np.float32)
    abuf = rng.uniform(-high, high, (B, 4, m + in_extra)).astype(np.float32)
    if in_extra:
        abuf[..., -1] = np.abs(abuf[..., -1]) * 0.05
    return obs, abuf


def models(env, cfg_kw=None):
    n, m, high = ENV_DIMS[env]
    cfg_kw = cfg_kw or {}
    jmodel = jax_make_model("nl", env, n, m, high, JConfig(**cfg_kw), dtype=jnp.float32)
    tmodel = torch_make_model("nl", env, n, m, high, TConfig(**cfg_kw), device="cpu")
    return jmodel, tmodel


def jax_tree(tparams):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)


@pytest.mark.parametrize(
    "env,cfg_kw",
    [
        ("oderl-pendulum", {}),
        ("oderl-cartpole", {}),
        ("oderl-acrobot", {}),
        ("oderl-cartpole", {"encode_obs_time": True}),
        ("oderl-pendulum", {"normalize": False}),
    ],
    ids=["pendulum", "cartpole", "acrobot", "encode_obs_time", "no_normalize"],
)
def test_pack_nl_forward_matches_jax(env, cfg_kw):
    """The host-side fold is the JAX code: identical float32 operands."""
    n, m, high = ENV_DIMS[env]
    jmodel, _ = models(env, cfg_kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), jparams)
    norm = norm_stats_for(env, high, m)
    args = (0.125, n, m, 17, norm.state_mean, norm.state_std, norm.action_mean, norm.action_std)
    kw = dict(normalize=cfg_kw.get("normalize", True), encode_obs_time=cfg_kw.get("encode_obs_time", False))
    exp = jnl.pack_nl_forward(jparams, *args, **kw)
    got = tnl.pack_nl_forward(tparams, *args, **kw)
    assert len(got) == len(exp) == 21
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g.dtype == np.float32, i
        np.testing.assert_array_equal(g, np.asarray(e), err_msg=f"operand {i}")


@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_plain_forward_matches_jax_pallas_kernel(env):
    """nl_forward_plain on trained delay-1 weights vs the JAX fused kernel in
    interpret mode, and vs the port's unfused apply."""
    n, m, _ = ENV_DIMS[env]
    tparams = trained(env)
    jmodel, tmodel = models(env)
    obs, abuf = draw(env, 96)
    ts = np.full((96, 1), DT, np.float32)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jmodel.make_fused_planner_apply(jax_tree(tparams), DT)(None, obs, abuf, ts))

    fused = tmodel.make_fused_planner_apply(tparams, DT)
    got = fused(None, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts))
    assert got.shape == (96, n) and got.dtype == torch.float32
    assert rel_err(got, exp) < TOL
    plain = tnl.nl_forward_plain(torch.tensor(obs), torch.tensor(abuf.reshape(96, -1)), fused.packed, n, m)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())

    unfused = tmodel.apply(tparams, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts))
    assert rel_err(got, unfused) < TOL


@pytest.mark.parametrize("B", [16, 300])
def test_plain_head_matches_jax_pallas_kernel(B):
    """nl_head_plain vs the JAX head kernel in interpret mode: on the inputs
    of tests/test_pallas_ilt.py, and on trained head weights fed hidden
    states in the trunk's tanh range."""
    D, terms, H = 5, 17, 128
    rng = np.random.default_rng(B)
    x_normal = rng.standard_normal((B, H)).astype(np.float32)
    head = trained("oderl-cartpole")["laplace_rep"][-1]
    for x, w, b in (
        (x_normal, rng.standard_normal((H, 2 * D * terms)).astype(np.float32) * 0.05,
         rng.standard_normal(2 * D * terms).astype(np.float32) * 0.05),
        (np.tanh(x_normal), head["w"].numpy(), head["b"].numpy()),
    ):
        jpacked = jilt.pack_head_weights(w, b, D, terms, 0.125)
        with pltpu.force_tpu_interpret_mode():
            exp = np.asarray(jilt.nl_head_fused(jnp.asarray(x), jpacked, D))
        tpacked = tilt.to_device(tilt.pack_head_weights(w, b, D, terms, 0.125), "cpu")
        for g, e in zip(tpacked, jpacked):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        got = tilt.nl_head_fused(torch.tensor(x), tpacked, D, terms=terms)
        assert got.shape == (B, D)
        assert rel_err(got, exp) < TOL


def test_fourier_weights_match_jax():
    for t in (0.125, 0.2, 2.5e-3):
        for g, e in zip(tilt.fourier_weights(t, 17), jilt.fourier_weights(t, 17)):
            np.testing.assert_array_equal(g, e)


def test_cpu_wrappers_compute_plain_and_count_no_launch():
    env = "oderl-cartpole"
    n, m, _ = ENV_DIMS[env]
    _, tmodel = models(env)
    fused = tmodel.make_fused_planner_apply(trained(env), DT)
    obs, abuf = (torch.tensor(a) for a in draw(env, 8))
    before = (tnl.nl_forward_fused.launches, tilt.nl_head_fused.launches)
    tnl.nl_forward_fused(obs, abuf.reshape(8, -1), fused.packed, n, m, terms=17)
    tilt.nl_head_fused(torch.zeros(8, 128), fused.packed[15:], n, terms=17)
    assert (tnl.nl_forward_fused.launches, tilt.nl_head_fused.launches) == before


def test_launch_rejects_cpu_operands_before_building():
    with pytest.raises(ValueError, match="expected"):
        nl_cuda.launch("nl_head_launch", (torch.zeros(2, 2),) * 8, (2,) * 7)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nl_kernels.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nl_cuda, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="error: broken"):
        nl_cuda.build(tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """A built library for the current sources is reused; nvcc is not run."""
    lib = tmp_path / nl_cuda._digest() / "libnl_kernels.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    monkeypatch.setattr(nl_cuda, "find_nvcc", lambda: pytest.fail("nvcc must not run"))
    assert nl_cuda.build(tmp_path) == lib


# ---- the kernels' layout, unpacked and evaluated as the kernels compute it ----


def frag_unpack(flat, K, M):
    """Inverse of ``pallas_nl.frag_pack``: the [K, M] matrix."""
    rows, cols = tnl._frag_index(K, M)
    out = np.zeros((tilt._round_up(K, tnl.MMA_K), tilt._round_up(M, tnl.MMA_M)), np.float32)
    out[rows, cols] = np.asarray(flat, np.float32).reshape(rows.shape)
    return out[:K, :M]


def gru_untiles(flat, kin, H):
    """Inverse of ``pallas_nl._gru_tiles``: (w_ih [kin, 3H], w_hh [H, 3H])."""
    group, mk = tnl._GROUP, tnl.MMA_K
    kx = tilt._round_up(kin, mk)
    ks = (kx + H) // mk
    cat = np.zeros((kx + H, 3 * H), np.float32)
    per = ks * 32 * 6
    for g in range(H // group):
        u = g * group + np.arange(group)
        rz_flat, half = np.split(np.asarray(flat[g * per : (g + 1) * per]), [ks * 128])
        cat[:, np.concatenate([u, H + u])] = frag_unpack(rz_flat, kx + H, tnl.MMA_M)
        frags = np.zeros((ks, 32, 4), np.float32)
        half = half.reshape(ks, 32, 2)
        frags[: kx // mk][..., [0, 2]] = half[: kx // mk]
        frags[kx // mk :][..., [1, 3]] = half[kx // mk :]
        cand = frag_unpack(frags.reshape(-1), kx + H, tnl.MMA_M)
        cat[:kx, 2 * H + u] = cand[:kx, :group]
        cat[kx:, 2 * H + u] = cand[kx:, group:]
    return cat[:kin], cat[kx:]


def gru_wide_untiles(flat, kin, H):
    """Inverse of ``pallas_nl._gru_wide_tiles``: (w_ih [kin, 3H], w_hh [H, 3H]);
    the m-tiles' padding past H is zero."""
    kx = tilt._round_up(kin, tnl.MMA_K)
    ks, mt = (kx + H) // tnl.MMA_K, tilt._round_up(H, tnl.MMA_M) // tnl.MMA_M
    tiles = np.asarray(flat).reshape(mt, ks, 3, 128)
    cat = np.zeros((kx + H, 3 * H), np.float32)
    for g in range(3):
        full = frag_unpack(tiles[:, :, g].reshape(-1), kx + H, mt * tnl.MMA_M)
        assert not full[:, H:].any() and not full[kin:kx].any()
        cat[:, g * H : (g + 1) * H] = full[:, :H]
    return cat[:kin], cat[kx:]


def unpack_head(buf, hx, D, terms):
    """``repack_head``'s buffer -> b_theta, b_phi, c_re, c_im [Mp] and
    w_theta, w_phi [hxp, Mp], Mp = chunks * Mc, the chunks side by side, hxp
    the input width padded to a multiple of 4."""
    chunks, mc = tilt.head_chunks(hx, D, terms)
    hx = tilt._round_up(hx, 4)
    per = tilt._host(buf).reshape(chunks, (4 + 2 * hx) * mc)
    vecs = np.concatenate([c[: 4 * mc].reshape(4, mc) for c in per], axis=1)
    w = np.concatenate([c[4 * mc :].reshape(hx, mc, 2) for c in per], axis=1)
    return {"b_theta": vecs[0], "b_phi": vecs[1], "c_re": vecs[2], "c_im": vecs[3],
            "w_theta": w[..., 0], "w_phi": w[..., 1]}


def unpack_nl_forward(buf, n, in_dim, H, hid, D, terms, actions=tnl.ACTION_STEPS):
    """``repack_nl_forward``'s buffer (packed for ``actions`` action steps)
    -> its dense parts, by name, at the padded widths
    (``pallas_nl.padded_widths``) of a model of widths H and hid. The wide
    layout's tag is zero."""
    sec = tnl.forward_sections(n, in_dim, H, hid, D, terms, actions)
    wide = tnl.wide_layout(n, in_dim, H, hid, D, terms, actions)
    H, hid = tnl.padded_widths(H, hid)
    parts = dict(zip(sec, np.split(tilt._host(buf).reshape(-1), np.cumsum(list(sec.values()))[:-1])))
    assert ("tag" in parts) == wide and not parts.get("tag", np.zeros(1)).any()
    small, gru1, gru2, w2, head = (parts[k] for k in ("small", "gru1", "gru2", "w2", "head"))
    latent = tnl._LATENT
    k1 = tilt._round_up(n + latent, tnl.MMA_K)
    sizes = [3 * H] * 4 + [latent * H, 4, k1 * hid, hid, hid]
    names = ["b_ih1", "b_hh1", "b_ih2", "b_hh2", "w_enc", "b_enc", "w1", "b1", "b2"]
    out = dict(zip(names, np.split(small, np.cumsum(sizes)[:-1])))
    out["w_enc"] = out["w_enc"].reshape(H, latent)
    out["b_enc"] = out["b_enc"][:latent]
    w1 = frag_unpack(out.pop("w1"), n + latent, hid)
    out["w1_obs"], out["w1_act"] = w1[:n], w1[n:]
    untiles = gru_wide_untiles if wide else gru_untiles
    out["w_ih1"], out["w_hh1"] = untiles(gru1, in_dim, H)
    out["w_ih2"], out["w_hh2"] = untiles(gru2, H, H)
    out["w2"] = frag_unpack(w2, hid, hid)
    out["head"] = head
    return out


def head_repacked_plain(x, buf, D, terms):
    """The head as the kernels compute it, on ``repack_head``'s buffer: the live
    columns only and the compact combine weights, at x's dtype."""
    h = {k: torch.as_tensor(v).to(x.dtype) for k, v in unpack_head(buf, x.shape[1], D, terms).items()}
    f_re, f_im = tilt._sphere_f(x @ h["w_theta"] + h["b_theta"], x @ h["w_phi"] + h["b_phi"])
    contrib = (f_re * h["c_re"] - f_im * h["c_im"])[:, : D * terms]
    return contrib.reshape(x.shape[0], D, terms).sum(-1)


def forward_repacked_plain(obs, acts_flat, buf, dims, matmul=torch.matmul):
    """The forward as the kernel computes it, on ``repack_nl_forward``'s buffer:
    the r/z gates over [x; h] in one product, the encoder in f32, the trunk's
    first layer over [obs; latent], the head over its live columns.
    ``dims`` = (n, in_dim, H, hid, D, terms), the model's widths, which the
    buffer holds padded; ``matmul`` stands for the products the kernel runs
    on the tensor cores."""
    n, in_dim, H, hid, D, terms = dims
    p = {k: torch.as_tensor(v) for k, v in unpack_nl_forward(buf, *dims).items()}
    H = tnl.padded_widths(H, hid)[0]
    B = obs.shape[0]
    A = acts_flat.shape[1] // in_dim

    def layer(x, h, w_ih, w_hh, b_ih, b_hh):
        rz = matmul(torch.cat([x, h], 1), torch.cat([w_ih, w_hh])[:, : 2 * H])
        r = torch.sigmoid(rz[:, :H] + b_ih[:H] + b_hh[:H])
        z = torch.sigmoid(rz[:, H:] + b_ih[H : 2 * H] + b_hh[H : 2 * H])
        cand = torch.tanh(matmul(x, w_ih[:, 2 * H :]) + b_ih[2 * H :]
                          + r * (matmul(h, w_hh[:, 2 * H :]) + b_hh[2 * H :]))
        return cand + z * (h - cand)

    h1 = obs.new_zeros((B, H))
    h2 = obs.new_zeros((B, H))
    for step in range(A):
        src = A - 1 - step
        x_t = acts_flat[:, src * in_dim : (src + 1) * in_dim]
        h1 = layer(x_t, h1, p["w_ih1"], p["w_hh1"], p["b_ih1"], p["b_hh1"])
        h2 = layer(h1, h2, p["w_ih2"], p["w_hh2"], p["b_ih2"], p["b_hh2"])
    p_act = h2 @ p["w_enc"] + p["b_enc"]
    hid1 = torch.tanh(matmul(torch.cat([obs, p_act], 1), torch.cat([p["w1_obs"], p["w1_act"]])) + p["b1"])
    hid2 = torch.tanh(matmul(hid1, p["w2"]) + p["b2"])
    return head_repacked_plain(hid2, p["head"], D, terms)


def round_tf32(x):
    """The TF32 value nearest a float32, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: the low 13 mantissa bits rounded off."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """x = hi + lo as the kernels split it: hi = the TF32 value nearest x, lo =
    the TF32 value nearest x - hi (x - hi is exact in float32)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def split_tf32_matmul(a, b):
    """a @ b as the kernels' tensor cores run it: hi*hi + hi*lo + lo*hi,
    summed in float32."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def one_pass_tf32_matmul(a, b):
    """The split's hi*hi product alone: one pass of TF32."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def fused_cpu(env, cfg_kw=None):
    """The port's fused apply on CPU: trained delay-1 weights, or for a
    non-default config (whose GRU input differs) the JAX init's weights."""
    jmodel, tmodel = models(env, cfg_kw)
    if not cfg_kw:
        return tmodel.make_fused_planner_apply(trained(env), DT)
    params = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), jmodel.init(jax.random.PRNGKey(0)))
    return tmodel.make_fused_planner_apply(params, DT)


WIDTHS = (24, 100, 160, 256, 512)  # nl_hidden_units past the width-128 cases: ragged, and past shared memory
WIDE_WIDTHS = (160, 256, 384, 520)  # the wide layout: GRU 80, 128, 192 and a ragged 260 (m-tiles padded)
# fourier terms whose head takes the resident layout past shared memory at width 128 on cartpole
WIDE_HEAD_TERMS = 104


@pytest.mark.parametrize(
    "env,cfg_kw,terms",
    [("oderl-pendulum", {}, 17), ("oderl-cartpole", {}, 17), ("oderl-acrobot", {}, 17),
     ("oderl-cartpole", {"encode_obs_time": True}, 17), ("oderl-acrobot", {}, 32)]
    + [("oderl-cartpole", {"nl_hidden_units": w}, 17) for w in sorted(set(WIDTHS + WIDE_WIDTHS))]
    + [("oderl-cartpole", {"nl_s_recon_terms": WIDE_HEAD_TERMS}, WIDE_HEAD_TERMS)],
    ids=["pendulum", "cartpole", "acrobot", "encode_obs_time", "acrobot_terms32"]
    + [f"width{w}" for w in sorted(set(WIDTHS + WIDE_WIDTHS))] + [f"width128_terms{WIDE_HEAD_TERMS}"],
)
def test_hopper_repack_loses_nothing(env, cfg_kw, terms):
    """Unpacking the kernel's buffer gives back every live entry of
    pack_nl_forward's operands, zero-padded to the kernel's widths, and the
    entries it drops are zero padding. At terms=32 every column of the padded
    blocks is live, and the head (192 columns on acrobot) is laid out in two
    chunks; a wide head takes more chunks, each within the stage. Past width
    128, and at width 128 where the resident layout does not fit in shared
    memory (a head of ``WIDE_HEAD_TERMS`` terms), the GRU's sections take
    the wide layout (``wide_layout``), whose unpacked tiles equal the padded
    operands as well."""
    torch.set_num_threads(1)
    n, m, _ = ENV_DIMS[env]
    in_dim = m + int(cfg_kw.get("encode_obs_time", False))
    fused = fused_cpu(env, cfg_kw)
    p = [t.numpy() for t in fused.packed]
    H, hid = p[1].shape[0], p[13].shape[0]
    Hp, hidp = tnl.padded_widths(H, hid)
    assert tnl.wide_layout(n, in_dim, H, hid, n, terms) == (
        cfg_kw.get("nl_hidden_units", 128) > 128 or terms == WIDE_HEAD_TERMS)
    buf = fused.hopper if terms == cfg_kw.get("nl_s_recon_terms", 17) else tnl.repack_nl_forward(p, n, in_dim, terms)
    chunks, mc = tilt.head_chunks(hid, n, terms)
    if hid == 128 and terms in (17, 32):
        assert chunks == (1 if terms == 17 else 2)
    assert mc % 4 == 0 and (mc * (4 + 2 * hidp) <= tilt._HEAD_STAGE_FLOATS or mc == 4)
    u = unpack_nl_forward(buf, n, in_dim, H, hid, n, terms)
    padded = tnl.pad_nl_forward(p)
    names = ["w_ih1", "w_hh1", "b_ih1", "b_hh1", "w_ih2", "w_hh2", "b_ih2", "b_hh2",
             "w_enc", "b_enc", "w1_obs", "w1_act", "b1", "w2", "b2"]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(u[name], padded[i].reshape(u[name].shape), err_msg=name)
    h = unpack_head(u["head"], hidp, n, terms)
    Tp = p[15].shape[1] // n
    d = np.repeat(np.arange(n), terms)
    live = d * Tp + np.tile(np.arange(terms), n)
    for got, full in ((h["w_theta"], p[15]), (h["w_phi"], p[16])):
        np.testing.assert_array_equal(got[:hid, : n * terms], full[:, live])
        assert not got[hid:].any() and not got[:, n * terms :].any()
        assert not np.delete(full, live, axis=1).any()
    for got, full in ((h["b_theta"], p[17]), (h["b_phi"], p[18])):
        np.testing.assert_array_equal(got[: n * terms], full.reshape(-1)[live])
    for got, full in ((h["c_re"], p[19]), (h["c_im"], p[20])):
        np.testing.assert_array_equal(got[: n * terms], full[live, d])
        dropped = full.copy()
        dropped[live, d] = 0.0
        assert not dropped.any()


def test_zero_padding_is_exact():
    """pad_nl_forward keeps every operand's entries and adds zeros, and at f64
    the plain forward on the padded weights lies within 1e-12 of the forward
    on the unpadded ones, at ragged GRU and trunk widths (100: GRU 50 -> 56,
    trunk 100 -> 112; 24: 12 -> 16, 24 -> 32)."""
    env = "oderl-cartpole"
    n, m, high = ENV_DIMS[env]
    for width in (24, 100):
        jmodel, tmodel = models(env, {"nl_hidden_units": width})
        params = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), jmodel.init(jax.random.PRNGKey(1)))
        packed = tuple(x.double().numpy() for x in tmodel.make_fused_planner_apply(params, DT).packed)
        padded = tnl.pad_nl_forward(packed)
        H, Hp = width // 2, tilt._round_up(width // 2, 8)
        assert padded[1].shape == (Hp, 3 * Hp) and padded[13].shape == (tilt._round_up(width, 16),) * 2
        for i, (got, exp) in enumerate(zip(padded, packed)):
            assert got.dtype == np.float64
            live = np.concatenate([got[..., g * Hp : g * Hp + H] for g in range(3)], -1) if i < 8 else got
            np.testing.assert_array_equal(live[tuple(slice(0, k) for k in exp.shape)], exp, err_msg=str(i))
            assert np.abs(got).sum() == np.abs(exp).sum()  # the rest is zero
        rng = np.random.default_rng(width)
        obs = torch.tensor(rng.standard_normal((64, n)))
        acts = torch.tensor(rng.uniform(-high, high, (64, 4 * m)))
        exp = tnl.nl_forward_plain(obs, acts, tuple(map(torch.tensor, packed)), n, m)
        got = tnl.nl_forward_plain(obs, acts, tuple(map(torch.tensor, padded)), n, m)
        assert float((got - exp).abs().max()) <= 1e-12 * (1.0 + float(exp.abs().max()))


@pytest.mark.parametrize(
    "env,width", [(env, 128) for env in sorted(ENV_DIMS)] + [("oderl-cartpole", w) for w in WIDTHS + (3072,)],
    ids=sorted(ENV_DIMS) + [f"width{w}" for w in WIDTHS + (3072,)],
)
def test_repacked_plain_matches_jax_pallas_kernel(env, width):
    """The forward as the kernel computes it (r/z over [x; h] in one product,
    the head over its live columns, the compact combine), on the kernel's
    buffer, vs the JAX fused kernel in interpret mode and vs nl_forward_plain;
    and the port's fused apply vs the JAX kernel: on the trained weights at
    width 128, on JAX's init at the other widths (padded in the buffer where
    ragged). At 3,072, past the width the PR 15 kernel refused, at 8 rows."""
    torch.set_num_threads(1)
    n, m, _ = ENV_DIMS[env]
    B = 96 if width == 128 else 8 if width > 1024 else 16
    obs, abuf = draw(env, B)
    ts = np.full((B, 1), DT, np.float32)
    if width == 128:
        tparams = trained(env)
        jmodel, _ = models(env)
        fused = fused_cpu(env)
    else:
        jmodel, tmodel = models(env, {"nl_hidden_units": width})
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), jparams)
        fused = tmodel.make_fused_planner_apply(tparams, DT)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jmodel.make_fused_planner_apply(jax_tree(tparams), DT)(None, obs, abuf, ts))
    acts = torch.tensor(abuf.reshape(B, -1))
    H, hid = fused.packed[1].shape[0], fused.packed[13].shape[0]
    got = forward_repacked_plain(torch.tensor(obs), acts, fused.hopper, (n, m, H, hid, n, 17))
    assert got.shape == (B, n) and got.dtype == torch.float32
    assert rel_err(got, exp) < TOL
    plain = tnl.nl_forward_plain(torch.tensor(obs), acts, fused.packed, n, m)
    assert rel_err(got, plain) < KERNEL_TOL
    assert rel_err(fused(None, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts)), exp) < TOL


@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_split_tf32_emulation_within_kernel_tol(env):
    """The kernels' split-TF32 products, emulated, stay under the 1e-3 limit
    against nl_forward_plain at the main path's K=1000; one pass of TF32 does
    not. Run with -s to print both errors."""
    n, m, high = ENV_DIMS[env]
    fused = fused_cpu(env)
    rng = np.random.default_rng(3)
    obs = torch.tensor(rng.standard_normal((1000, n)), dtype=torch.float32)
    acts = torch.tensor(rng.uniform(-high, high, (1000, 4 * m)), dtype=torch.float32)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, m)
    dims = (n, m, 64, 128, n, 17)
    split = rel_err(forward_repacked_plain(obs, acts, fused.hopper, dims, split_tf32_matmul), exp)
    single = rel_err(forward_repacked_plain(obs, acts, fused.hopper, dims, one_pass_tf32_matmul), exp)
    print(f"{env}: split TF32 rel err {split:.3e}, one-pass TF32 {single:.3e}")
    assert split < KERNEL_TOL
    assert single > KERNEL_TOL


@pytest.mark.parametrize("env,delay", [(e, d) for e in sorted(ENV_DIMS) for d in (0, 2, 3)],
                         ids=[f"{e.split('-')[1]}_d{d}" for e in sorted(ENV_DIMS) for d in (0, 2, 3)])
def test_kernel_forward_on_every_table_checkpoint(env, delay):
    """The paper's table beyond delay 1: on each tracked NL checkpoint (the
    pendulum d0 one under the age channel, its ages raw), the port's fused
    apply against the JAX fused kernel in interpret mode (1e-2, as
    tests/test_pallas_nl.py), and the forward as the kernel computes it on
    its buffer against nl_forward_plain, in f32 and with the split-TF32
    products emulated at the main path's K=1000 (the card's 1e-3)."""
    n, m, _ = ENV_DIMS[env]
    age = (env, delay) == ("oderl-pendulum", 0)
    cfg_kw = {"encode_obs_time": True} if age else {}
    in_dim = m + int(age)
    tparams = trained(env, delay)
    assert tparams["encoder"]["gru"][0]["w_ih"].shape[0] == in_dim
    jmodel, tmodel = models(env, cfg_kw)
    fused = tmodel.make_fused_planner_apply(tparams, DT)
    obs, abuf = draw(env, 96, in_extra=int(age))
    ts = np.full((96, 1), DT, np.float32)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jmodel.make_fused_planner_apply(jax_tree(tparams), DT)(None, obs, abuf, ts))
    assert rel_err(fused(None, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts)), exp) < TOL
    obs, abuf = (torch.tensor(x) for x in draw(env, 1000, seed=4, in_extra=int(age)))
    acts = abuf.reshape(1000, -1)
    plain = tnl.nl_forward_plain(obs, acts, fused.packed, n, in_dim)
    dims = (n, in_dim, 64, 128, n, 17)
    assert rel_err(forward_repacked_plain(obs, acts, fused.hopper, dims), plain) < KERNEL_TOL
    assert rel_err(forward_repacked_plain(obs, acts, fused.hopper, dims, split_tf32_matmul), plain) < KERNEL_TOL


def test_tf32_split():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -1.0 - 3 * 2.0**-12, 3.0e-5, 7.1,
                      1.0 + 2.0**-11 - 2.0**-23], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all() and (lo.view(torch.int32) & 0x1FFF == 0).all()
    # to nearest, ties away from zero
    assert hi[0] == 1.0 and hi[1] == 1.0 + 2.0**-10 and hi[2] == 1.0 + 2.0**-9
    assert hi[3] == -1.0 - 2.0**-10 and hi[6] == 1.0
    assert torch.equal(hi + (x - hi), x) and ((x - hi).abs() <= x.abs() * 2.0**-11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0**-22).all()
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((64, 128)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((128, 96)), dtype=torch.float32)
    ref = a.double() @ b.double()
    assert float((split_tf32_matmul(a, b).double() - ref).abs().max()) < 1e-4
    assert float((one_pass_tf32_matmul(a, b).double() - ref).abs().max()) > 1e-3


def test_split_tf32_on_early_weights():
    """On the JAX run's init weights (artifacts/port/jax_train_pendulum_d1.npz)
    at B=1,000, with the inputs of scripts/port_train_numerics.py kernel, the
    emulated split forward lies no further from the f64 forward than 1.5
    times the f32 plain forward does (chip_smoke.forward_errors). A split
    that truncates hi, and has lo read truncated, lies 2.4 times as far."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    params = chip_smoke.read_jax_train_reference()["init"]
    model = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(), device="cpu")
    fused = model.make_fused_planner_apply(from_jax_params(params, device="cpu"), DT)
    rng = np.random.default_rng(1000)
    obs = torch.tensor(rng.standard_normal((1000, 3)), dtype=torch.float32)
    acts = torch.tensor(rng.uniform(-2.0, 2.0, (1000, 4)), dtype=torch.float32)
    got = forward_repacked_plain(obs, acts, fused.hopper, (3, 1, 64, 128, 3, 17), split_tf32_matmul)
    e = chip_smoke.forward_errors(got, obs, acts, fused.packed, 3, 1)
    print(f"split {e['kernel_vs_plain64']:.3e}, f32 plain {e['plain_vs_plain64']:.3e}")
    assert e["kernel_vs_plain64"] <= 1.5 * e["plain_vs_plain64"]


# ---- the streamed variant's stage kernels, walked tile by tile ----

WIDE_K = 4  # k-steps a ring stage (kWideK)
WIDE_COLS = 4  # m-tiles of 16 columns a GEMM stage's CTA (kColMt)
_LANE, _REG = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
FRAG_M, FRAG_K = (_LANE >> 2) + 8 * (_REG & 1), (_LANE & 3) + 4 * (_REG >> 1)  # a fragment's (m, k) by lane, register


def plane_index(K, bp):
    """``plane_at`` of csrc/nl_kernels.cu: the hi float of (k, row) in split
    planes of K x bp; lo lies 64 floats further."""
    k, r = np.arange(K)[:, None], np.arange(bp)[None, :]
    return ((k >> 3) * (bp // 8) + (r >> 3)) * 128 + ((k & 7) >> 2) * 32 + (r & 7) * 4 + (k & 3)


class WideWalk:
    """The streamed variant's chain on ``repack_nl_forward``'s wide buffer, as
    its stage kernels walk it: each GEMM stage over (row tile, column tile of
    4 m-tiles, chunk of ``WIDE_K`` k-steps), the weights read by the
    producer's offsets and decoded from their fragments, the activations
    read from split planes (``plane_index``) and written back split by each
    epilogue, the GRU's K loop over x's chunks and then h's with the
    candidate's two halves summed apart. ``split`` (None: f64, no split)
    splits each chunk's operands as the tensor cores read them (weights
    split as loaded, activations stored split), the large product summed in
    f32 apart from the two small ones."""

    def __init__(self, buf, dims, rows, gru_rows, dense_rows, split=None, actions=tnl.ACTION_STEPS):
        self.n, self.in_dim, H, hid, self.D, self.terms = dims
        self.H, self.hid = tnl.padded_widths(H, hid)
        self.sec = tnl.forward_sections(*dims, actions)
        assert "tag" in self.sec
        self.off = dict(zip(self.sec, np.cumsum([0] + list(self.sec.values()))))
        self.split = split
        self.dtype = torch.float32 if split else torch.float64
        self.buf = torch.as_tensor(np.asarray(buf)).to(self.dtype)
        self.B, self.bp = rows, tilt._round_up(max(rows, 1), 128)
        self.gru_rows, self.dense_rows = gru_rows, dense_rows

    def planes(self, X):
        """[B, K] -> split planes (zero rows past B)."""
        K = X.shape[1]
        idx = torch.as_tensor(plane_index(K, self.bp)[:, : self.B].T.reshape(-1))
        hi, lo = split_tf32(X) if self.split else (X, torch.zeros_like(X))
        P = torch.zeros(2 * K * self.bp, dtype=self.dtype)
        P[idx], P[idx + 64] = hi.reshape(-1), lo.reshape(-1)
        return P

    def read(self, P, K):
        """Split planes -> [B, K] as hi + lo."""
        idx = torch.as_tensor(plane_index(K, self.bp)[:, : self.B].T)
        return P[idx] + P[idx + 64]

    def tile_weights(self, w0, ks, G, mt0, live, kw, kn):
        """The producer's copy of a tile (``live`` m-tiles, k-steps kw..kw+kn)
        decoded: [G][kn 8][live 16], as lane and register lay it out."""
        out = torch.zeros((G, kn * 8, live * 16), dtype=self.dtype)
        for m in range(live):
            at = w0 + ((mt0 + m) * ks + kw) * G * 128
            frags = self.buf[at : at + kn * G * 128].reshape(kn, G, 32, 4)
            for i in range(kn):
                out[:, i * 8 + FRAG_K, m * 16 + FRAG_M] = frags[i]
        return out

    def tile_acts(self, P, k0, kn, r0, nr):
        """The producer's copy of rows r0..r0+nr at k-steps k0..k0+kn: (hi, lo) [nr, kn 8]."""
        hi = torch.zeros((nr, kn * 8), dtype=self.dtype)
        lo = torch.zeros_like(hi)
        for i in range(kn):
            at = ((k0 + i) * (self.bp // 8) + r0 // 8) * 128
            blk = P[at : at + nr // 8 * 128].reshape(nr // 8, 2, 2, 8, 4)  # [rg][hi/lo][k half][row][k]
            for pl, dst in ((0, hi), (1, lo)):
                dst[:, i * 8 : i * 8 + 8] = blk[:, pl].permute(0, 2, 1, 3).reshape(nr, 8)
        return hi, lo

    def product(self, w, a_hi, a_lo):
        """acts [nr, k] x tile weights [k, m] for one chunk: (large, small)."""
        if not self.split:
            return (a_hi + a_lo) @ w, torch.zeros((a_hi.shape[0], w.shape[1]), dtype=self.dtype)
        w_hi, w_lo = split_tf32(w)
        return a_hi @ w_hi, a_lo @ w_hi + a_hi @ w_lo

    def gemm(self, w0, ks, G, mtiles, x, ksx, h, ksh, rows_tile):
        """One GEMM stage: the pre-activations [G (+1 for the GRU's candidate
        input half)][B][mtiles 16] its CTAs leave in their accumulators."""
        cols = mtiles * 16
        acc = torch.zeros((G + (G == 3), self.bp, cols), dtype=self.dtype)
        cx = -(-ksx // WIDE_K)
        chunks = cx + -(-ksh // WIDE_K)
        for r0 in range(0, self.B, rows_tile):
            for ct in range(-(-mtiles // WIDE_COLS)):
                mt0, live = ct * WIDE_COLS, min(WIDE_COLS, mtiles - ct * WIDE_COLS)
                big = torch.zeros((G, rows_tile, live * 16), dtype=self.dtype)
                small = torch.zeros_like(big)
                nx = None
                for c in range(chunks):
                    if G == 3 and c == cx:
                        nx, big[2], small[2] = big[2] + small[2], 0.0, 0.0
                    in_x = c < cx
                    k0 = (c if in_x else c - cx) * WIDE_K
                    kn = min(WIDE_K, (ksx if in_x else ksh) - k0)
                    w = self.tile_weights(w0, ks, G, mt0, live, k0 if in_x else ksx + k0, kn)
                    a_hi, a_lo = self.tile_acts(x if in_x else h, k0, kn, r0, rows_tile)
                    for q in range(G):
                        b, s = self.product(w[q], a_hi, a_lo)
                        big[q] += b
                        small[q] += s
                if G == 3 and nx is None:
                    nx, big[2], small[2] = big[2] + small[2], 0.0, 0.0
                cs = slice(mt0 * 16, (mt0 + live) * 16)
                acc[:G, r0 : r0 + rows_tile, cs] = big + small
                if G == 3:
                    acc[3, r0 : r0 + rows_tile, cs] = nx
        return acc[:, : self.B]

    def gru(self, layer, x, ksx, h):
        H = self.H
        w0 = self.off["gru1" if layer == 1 else "gru2"]
        mtiles = tilt._round_up(H, 16) // 16
        acc = self.gemm(w0, ksx + H // 8, 3, mtiles, x, ksx, h, H // 8 if h is not None else 0, self.gru_rows)
        r_, z_, nh, nx = (a[:, :H] for a in acc)
        b = self.buf[6 * H * (layer - 1) : 6 * H * layer]
        b_ih, b_hh = b[: 3 * H], b[3 * H :]
        r = torch.sigmoid(r_ + b_ih[:H] + b_hh[:H])
        z = torch.sigmoid(z_ + b_ih[H : 2 * H] + b_hh[H : 2 * H])
        n = torch.tanh(nx + b_ih[2 * H :] + r * (nh + b_hh[2 * H :]))
        h_old = self.read(h, H) if h is not None else torch.zeros_like(n)
        return self.planes(n + z * (h_old - n))

    def __call__(self, obs, acts_flat):
        H, hid, n = self.H, self.hid, self.n
        obs, acts_flat = obs.to(self.dtype), acts_flat.to(self.dtype)
        A = acts_flat.shape[1] // self.in_dim
        kx = tilt._round_up(self.in_dim, 8)
        k1 = tilt._round_up(n + 2, 8)
        xs = [self.planes(torch.nn.functional.pad(acts_flat[:, s * self.in_dim : (s + 1) * self.in_dim],
                                                  (0, kx - self.in_dim))) for s in range(A)]
        h1 = h2 = None
        for step in range(A):  # newest action first
            h1 = self.gru(1, xs[A - 1 - step], kx // 8, h1)
            h2 = self.gru(2, h1, H // 8, h2)
        small = self.buf[: self.sec["small"]]
        w_enc, b_enc = small[12 * H : 14 * H].reshape(H, 2), small[14 * H : 14 * H + 2]
        latent = self.read(h2, H) @ w_enc + b_enc  # f32 on the CUDA cores
        z1 = torch.nn.functional.pad(torch.cat([obs, latent], 1), (0, k1 - n - 2))
        w1 = self.tile_weights(14 * H + 4, k1 // 8, 1, 0, hid // 16, 0, k1 // 8)[0]
        b1 = small[14 * H + 4 + k1 * hid : 14 * H + 4 + k1 * hid + hid]
        b2 = small[14 * H + 4 + k1 * hid + hid :]
        hi, lo = split_tf32(z1) if self.split else (z1, torch.zeros_like(z1))
        big, sm = self.product(w1, hi, lo)
        hid1 = self.planes(torch.tanh(big + sm + b1))
        hid2 = torch.tanh(self.gemm(self.off["w2"], hid // 8, 1, hid // 16, hid1, hid // 8, None, 0,
                                    self.dense_rows)[0] + b2)
        return head_repacked_plain(hid2, self.buf[self.off["head"] : self.off["tag"]], self.D, self.terms)


def wide_params(width, seed=0):
    """The port's init at ``width`` on cartpole, drawn from a seed."""
    n, m, high = ENV_DIMS["oderl-cartpole"]
    model = torch_make_model("nl", "oderl-cartpole", n, m, high, TConfig(nl_hidden_units=width), device="cpu")
    return model, model.init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("width", WIDE_WIDTHS)
def test_wide_stage_walk_matches_plain(width):
    """The stage kernels' tile walk (``WideWalk``) on the wide buffer equals
    nl_forward_plain to 1e-12 at f64, at B = 1, 63 and 129 and each row tile
    the plan may take (32/64 rows in the GRU, 32/64/128 in trunk layer 2,
    ragged B in every tile); and with the split-TF32 products emulated, on
    the tracked cartpole checkpoint widened to the width
    (``chip_smoke.widen_nl``), within KERNEL_TOL of the f32 plain forward."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    torch.set_num_threads(1)
    n, m, high = ENV_DIMS["oderl-cartpole"]
    model, params = wide_params(width)
    fused = model.make_fused_planner_apply(params, DT)
    H, hid = fused.packed[1].shape[0], fused.packed[13].shape[0]
    dims = (n, m, H, hid, n, 17)
    assert tnl.wide_layout(*dims)
    p64 = tuple(x.double() for x in fused.packed)
    for B, gru_rows, dense_rows in ((1, 32, 32), (63, 64, 128), (129, 32, 64)):
        rng = np.random.default_rng(B + width)
        obs = torch.tensor(rng.standard_normal((B, n)))
        acts = torch.tensor(rng.uniform(-high, high, (B, 4 * m)))
        got = WideWalk(fused.hopper, dims, B, gru_rows, dense_rows)(obs, acts)
        exp = tnl.nl_forward_plain(obs, acts, p64, n, m)
        assert got.dtype == torch.float64 and got.shape == (B, n)
        assert float((got - exp).abs().max()) <= 1e-12 * (1.0 + float(exp.abs().max())), (B, gru_rows)

    wide = model.make_fused_planner_apply(chip_smoke.widen_nl(trained("oderl-cartpole"), width, seed=width), DT)
    obs, acts = (torch.as_tensor(x) for x in draw("oderl-cartpole", 129))
    acts = acts.reshape(129, -1)
    got = WideWalk(wide.hopper, dims, 129, 64, 128, split=split_tf32)(obs, acts)
    assert got.dtype == torch.float32
    assert rel_err(got, tnl.nl_forward_plain(obs, acts, wide.packed, n, m)) < KERNEL_TOL


@pytest.mark.parametrize("terms,actions", [(WIDE_HEAD_TERMS, 4), (17, 40)], ids=[f"terms{WIDE_HEAD_TERMS}", "actions40"])
def test_wide_layout_where_resident_does_not_fit(terms, actions):
    """At width 128, where the resident kernel's GRU groups still reach, a
    head of ``WIDE_HEAD_TERMS`` terms or an action buffer of 40 steps needs
    more shared memory than a block has (``resident_bytes``), so the host
    packs the wide layout for the streamed variant (at 17 terms and 4 steps
    it packs the resident one): the buffer unpacks to the padded operands,
    and the stage kernels' walk on it equals nl_forward_plain to 1e-12 at
    f64 over ``actions`` steps, at B = 1 and 63."""
    torch.set_num_threads(1)
    n, m, high = ENV_DIMS["oderl-cartpole"]
    model = torch_make_model("nl", "oderl-cartpole", n, m, high, TConfig(nl_s_recon_terms=terms), device="cpu")
    fused = model.make_fused_planner_apply(model.init(torch.Generator().manual_seed(terms)), DT, actions)
    H, hid = fused.packed[1].shape[0], fused.packed[13].shape[0]
    dims = (n, m, H, hid, n, terms)
    assert (H, hid) == (64, 128) and not tnl.wide_layout(n, m, H, hid, n, 17, 4)
    assert tnl.resident_bytes(n, actions, m, H, hid, n, terms) > tnl._SMEM_BUDGET
    assert tnl.wide_layout(*dims, actions) and fused.hopper.numel() == sum(tnl.forward_sections(*dims, actions).values())
    u = unpack_nl_forward(fused.hopper, *dims, actions=actions)
    padded = tnl.pad_nl_forward([t.numpy() for t in fused.packed])
    for i, name in enumerate(["w_ih1", "w_hh1", "b_ih1", "b_hh1", "w_ih2", "w_hh2", "b_ih2", "b_hh2"]):
        np.testing.assert_array_equal(u[name], padded[i].reshape(u[name].shape), err_msg=name)
    p64 = tuple(x.double() for x in fused.packed)
    for B in (1, 63):
        rng = np.random.default_rng(B + actions)
        obs = torch.tensor(rng.standard_normal((B, n)))
        acts = torch.tensor(rng.uniform(-high, high, (B, actions * m)))
        got = WideWalk(fused.hopper, dims, B, 32, 32, actions=actions)(obs, acts)
        exp = tnl.nl_forward_plain(obs, acts, p64, n, m)
        assert float((got - exp).abs().max()) <= 1e-12 * (1.0 + float(exp.abs().max())), B


@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_cluster_roles_fit_wherever_the_resident_layout_does(env):
    """The resident kernel's cluster walk splits the weights between a GRU
    CTA and a trunk/head CTA at 16 rows a tile; the library takes it (from
    11,000 rows) where both roles fit in a block's shared memory
    (``tile_bytes``) and runs one tile a CTA elsewhere on the resident
    layout. Both fit at the action buffer's 4 steps and 17 terms at every
    width up to 128, ragged ones included, with and without the age channel,
    and at 32 terms, where the head (two chunks on acrobot and cartpole)
    passes through the trunk/head CTA a chunk at a time. The set of dims on
    the resident layout is the one the one-tile walk's footprint
    (``resident_bytes``) gives, as before the cluster walk: at width 128 on
    cartpole 17 terms take it up to 33 action steps and 100 terms at 4 steps,
    and the two wide cases of ``test_wide_layout_where_resident_does_not_fit``
    stay wide."""
    n, m, _ = ENV_DIMS[env]
    for in_dim in (m, m + 1):
        for width in sorted(set(range(16, 129, 8)) | {24, 100, 101, 127}):
            H, hid = width // 2, width
            for terms in (17, 32):
                assert not tnl.wide_layout(n, in_dim, H, hid, n, terms)
                b = tnl.tile_bytes(n, 4, in_dim, H, hid, n, terms)
                assert max(b["gru"], b["trunk_head"]) <= tnl._SMEM_BUDGET, (width, terms, b)
                # one chunk is always resident; at width 128 two chunks stream beside trunk layer 2
                assert b["head_resident"] or tilt.head_chunks(hid, n, terms)[0] > 1, (width, terms)
                if width == 128:
                    assert b["head_resident"] == (tilt.head_chunks(hid, n, terms)[0] == 1), terms
    if env == "oderl-cartpole":
        assert not tnl.wide_layout(n, m, 64, 128, n, 17, 33) and tnl.wide_layout(n, m, 64, 128, n, 17, 34)
        assert not tnl.wide_layout(n, m, 64, 128, n, 100, 4)
        assert tnl.wide_layout(n, m, 64, 128, n, WIDE_HEAD_TERMS, 4) and tnl.wide_layout(n, m, 64, 128, n, 17, 40)
        assert tnl.tile_bytes(n, 4, m, 64, 128, n, 17) == {"gru": 212048, "trunk_head": 207568, "head_resident": True}
        assert tnl.resident_bytes(n, 4, m, 64, 128, n, 17) == 209456


@pytest.mark.parametrize(
    "env,terms,hx",
    [(env, 17, 128) for env in sorted(ENV_DIMS)] + [("oderl-cartpole", 32, 128)]
    + [("oderl-cartpole", 17, w) for w in WIDTHS + (101,)],
    ids=[f"{env}-17" for env in sorted(ENV_DIMS)] + ["oderl-cartpole-32"] + [f"hx{w}" for w in WIDTHS + (101,)],
)
def test_repacked_head_matches_plain(env, terms, hx):
    """The head on repack_head's buffer (live columns, compact combine, in
    chunks) vs nl_head_plain on pack_head_weights's operands. At terms=32
    the fourier sum runs over the blocks' zero-padded terms as well, and the
    head's 160 columns lie in two chunks. At other input widths Hx (seeded
    weights) the chunks narrow to fit the stage, and a ragged Hx (101) gets
    zero rows up to a multiple of 4."""
    n = ENV_DIMS[env][0]
    if hx == 128:
        head = trained(env)["laplace_rep"][-1]
        w, b = head["w"], head["b"]
    else:
        rng = np.random.default_rng(hx)
        w = rng.standard_normal((hx, 2 * n * 17)).astype(np.float32) / np.sqrt(hx)
        b = (0.1 * rng.standard_normal(2 * n * 17)).astype(np.float32)
    packed = tilt.to_device(tilt.pack_head_weights(w, b, n, 17, 0.125), "cpu")
    buf = tilt.repack_head(packed, n, terms)
    assert buf.size == tilt.head_size(hx, n, terms)
    x = torch.tensor(np.tanh(np.random.default_rng(1).standard_normal((200, hx))), dtype=torch.float32)
    got = head_repacked_plain(torch.nn.functional.pad(x, (0, tilt._round_up(hx, 4) - hx)), buf, n, terms)
    assert rel_err(got, tilt.nl_head_plain(x, packed, n)) < KERNEL_TOL


def test_repack_rejects_terms_past_the_block():
    head = trained("oderl-cartpole")["laplace_rep"][-1]
    packed = tilt.pack_head_weights(head["w"], head["b"], 5, 17, 0.125)
    with pytest.raises(ValueError, match="terms=33"):
        tilt.repack_head(packed, 5, 33)


@pytest.mark.parametrize("weights", ["init", "final"])
def test_forward_errors_scale_to_the_fourier_terms(weights):
    """chip_smoke.forward_errors, which holds the forward kernel on weights
    early in training, on the JAX run's weights of artifacts/port/
    jax_train_pendulum_d1.npz (init and after 250 updates). With the f32
    plain forward as the kernel's output it reads 0 against the plain
    forward and the plain forward's own distance to the f64 one. A shift of
    1e-3 times each output's term size, 1 + sum_k |term_k| with every term
    formed apart here, reads as 1e-3 in ``kernel_cond`` to within that
    distance, while ``kernel_vs_plain`` reads it as more than 1."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    params = chip_smoke.read_jax_train_reference()[weights]
    model = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(), device="cpu")
    packed = model.make_fused_planner_apply(from_jax_params(params, device="cpu"), DT).packed
    obs, acts = (torch.as_tensor(x) for x in draw("oderl-pendulum", 300))
    acts = acts.reshape(300, -1)
    plain = tnl.nl_forward_plain(obs, acts, packed, 3, 1)
    e = chip_smoke.forward_errors(plain, obs, acts, packed, 3, 1)
    assert e["kernel_vs_plain"] == 0.0 and e["kernel_cond"] == e["plain_cond"] < 1e-5
    assert e["max_term_sum"] >= e["max_abs_out"] > 1e3  # outputs cancel terms far larger

    p64 = tuple(x.double() for x in packed)
    hid = tnl.nl_trunk_plain(obs.double(), acts.double(), p64, 1)
    w_t, w_p, b_t, b_p, s_re, s_im = p64[15:]
    f_re, f_im = tilt._sphere_f(hid @ w_t + b_t, hid @ w_p + b_p)
    terms = f_re[:, :, None] * s_re[None] - f_im[:, :, None] * s_im[None]  # [B, cols, D]
    size = 1.0 + (f_re[:, :, None] * s_re[None]).abs().sum(1) + (f_im[:, :, None] * s_im[None]).abs().sum(1)
    exp64 = terms.sum(1)[:, :3]
    shifted = (exp64 + 1e-3 * size[:, :3]).float()
    s = chip_smoke.forward_errors(shifted, obs, acts, packed, 3, 1)
    assert abs(s["kernel_cond"] - 1e-3) < 1e-5 and s["kernel_vs_plain"] > 1.0


@pytest.mark.parametrize("width", [160, 512])
def test_widen_nl_embeds_the_tracked_checkpoint(width):
    """chip_smoke.widen_nl, the weights on which phase widths holds the
    streamed kernel to 1e-3: a tree of the width's shape with the tracked
    cartpole checkpoint in the leading GRU units of each gate block and the
    leading trunk columns. Its new units move the forward by more than ten
    times KERNEL_TOL, and the f32 plain forward stays within KERNEL_TOL of
    the f64 one."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from neurallaplacecontrol_tpu_torch.models.common import tree_leaves

    n, m, high = ENV_DIMS["oderl-cartpole"]
    params = trained("oderl-cartpole")
    wide = chip_smoke.widen_nl(params, width, seed=width)
    model = torch_make_model("nl", "oderl-cartpole", n, m, high, TConfig(nl_hidden_units=width), device="cpu")
    assert [x.shape for x in tree_leaves(wide)] == [
        x.shape for x in tree_leaves(model.init(torch.Generator().manual_seed(0)))]
    H, Hn = 64, width // 2
    for old, new in zip(params["encoder"]["gru"], wide["encoder"]["gru"]):
        for gate in range(3):
            assert torch.equal(new["w_hh"][:H, gate * Hn:gate * Hn + H], old["w_hh"][:, gate * H:(gate + 1) * H])
            assert torch.equal(new["b_ih"][gate * Hn:gate * Hn + H], old["b_ih"][gate * H:(gate + 1) * H])
    assert torch.equal(wide["laplace_rep"][1]["w"][:128, :128], params["laplace_rep"][1]["w"])

    obs, acts = (torch.as_tensor(x) for x in draw("oderl-cartpole", 500))
    acts = acts.reshape(500, -1)
    packed = model.make_fused_planner_apply(wide, DT).packed
    narrow = torch_make_model("nl", "oderl-cartpole", n, m, high, TConfig(), device="cpu")
    packed128 = narrow.make_fused_planner_apply(params, DT).packed

    def f64(p):
        return tnl.nl_forward_plain(obs.double(), acts.double(), tuple(x.double() for x in p), n, m)

    exp = f64(packed)
    assert rel_err(exp, f64(packed128)) > 10 * KERNEL_TOL
    assert rel_err(tnl.nl_forward_plain(obs, acts, packed, n, m), exp) < KERNEL_TOL
