"""The port's reduced-precision NL routes against the JAX package's on the
CPU: ``nl_compute_dtype="bfloat16"`` (models.nl) and the int8 planner
forward (ops.quant, after tests/test_quant.py). Every accuracy claim is on
the tracked cartpole-d1 checkpoint: untrained weights give pole-scale
outputs that amplify any perturbation. Tolerances are stated in each test."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.ops import quant as jquant
from neurallaplacecontrol_tpu_torch import serving as tserving
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves
from neurallaplacecontrol_tpu_torch.ops import quant as tquant
from neurallaplacecontrol_tpu_torch.training import eval as teval
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV, DELAY, N, M, HIGH, DT = "oderl-cartpole", 1, 5, 1, 3.0, 0.05


def trained(dtype=torch.float32):
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)
    return load_pytree(path, device="cpu", dtype=dtype)


def to_jax(params):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), params)


def batch(B, seed, scaled=True):
    """Inputs as tests/test_quant.py draws them (scaled obs) or as
    tests/test_models.py's bf16 test does (standard normal obs)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, N))
    if scaled:
        obs = obs * np.array([1.5, 6.0, 0.7, 0.7, 9.0])
    acts = rng.uniform(-3.0, 3.0, (B, 4, M))
    ts = np.full((B, 1), DT)
    return tuple(x.astype(np.float32) for x in (obs, acts, ts))


def rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return np.abs(got - exp) / (1.0 + np.abs(exp))


# --- bfloat16 -----------------------------------------------------------------


def test_bf16_forward_matches_jax_bf16():
    """B=512 on the trained checkpoint: the port's bf16 forward against JAX's
    bf16 forward, max relative gap < 3e-2 and median < 2e-3 (the two round
    the GRU's gates and the GEMMs' bf16 outputs in other places: 1.0e-2 and
    8.4e-4 measured, a fifth of bf16's own distance to f32); and against the
    port's f32 forward within tests/test_models.py's bounds for JAX's bf16
    (max < 0.10, median < 0.01)."""
    params = trained()
    obs, acts, ts = batch(512, 3, scaled=False)
    t_in = tuple(torch.tensor(x) for x in (obs, acts, ts))
    tbf = torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    t32 = torch_make_model("nl", ENV, N, M, HIGH, TConfig(), device="cpu")
    jbf = jax_make_model("nl", ENV, N, M, HIGH, JConfig(nl_compute_dtype="bfloat16"), dtype=jnp.float32)
    got = tbf.apply(params, *t_in)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    to_jax_bf16 = rel(got.numpy(), jax.jit(jbf.apply)(to_jax(params), obs, acts, ts))
    assert to_jax_bf16.max() < 3e-2 and np.median(to_jax_bf16) < 2e-3
    to_f32 = rel(got.numpy(), t32.apply(params, *t_in).numpy())
    assert to_f32.max() < 0.10 and np.median(to_f32) < 0.01
    assert to_f32.max() > 1e-3  # the route did run in bf16


def test_bf16_keeps_the_parameter_tree():
    """The init trees of both modes have equal keys, shapes and dtypes, so a
    checkpoint loads in either; the gradient through the bf16 forward is
    finite and in the parameters' dtype."""
    tbf = torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    t32 = torch_make_model("nl", ENV, N, M, HIGH, TConfig(), device="cpu")
    a, b = (m.init(torch.Generator().manual_seed(0)) for m in (t32, tbf))
    assert [(x.shape, x.dtype) for x in tree_leaves(a)] == [(x.shape, x.dtype) for x in tree_leaves(b)]
    params = trained()
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
    from neurallaplacecontrol_tpu_torch.models.common import tree_unflatten

    obs, acts, ts = batch(64, 4)
    loss = torch.mean(tbf.apply(tree_unflatten(params, leaves), *(torch.tensor(x) for x in (obs, acts, ts))) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


def test_bf16_cast_follows_the_parameters():
    """The bf16 casts are reused while the parameter tensors are unchanged,
    and an in-place update (a new tensor version) is seen at the next call;
    the window encoder and the encoded decode agree with ``apply``."""
    tbf = torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    params = trained()
    t_in = tuple(torch.tensor(x) for x in batch(32, 5))
    first = tbf.apply(params, *t_in)
    assert torch.equal(tbf.apply(params, *t_in), first)
    with torch.no_grad():
        params["laplace_rep"][2]["b"].add_(0.5)
    moved = tbf.apply(params, *t_in)
    fresh = torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    assert torch.equal(moved, fresh.apply(params, *t_in)) and not torch.equal(moved, first)
    encode = tbf.make_planner_window_encoder(params)
    obs, acts, ts = t_in
    assert torch.equal(tbf.apply_encoded(params, obs, encode(acts[:, None])[:, 0], ts), moved)


def test_bf16_fused_route_packs_float32():
    """With ``fused_nl_planner`` the bf16 config packs the same float32
    operands as the f32 config: the kernel's route is unchanged."""
    params = trained()
    packs = [torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype=d), device="cpu")
             .make_fused_planner_apply(params, DT) for d in ("float32", "bfloat16")]
    assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(packs[0].packed, packs[1].packed))
    assert torch.equal(packs[0].hopper, packs[1].hopper)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="nl_compute_dtype"):
        torch_make_model("nl", ENV, N, M, HIGH, TConfig(nl_compute_dtype="float16"), device="cpu")


# --- int8 ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    cfg = TConfig()
    spec = torch_make_env(ENV, dt=cfg.dt).spec
    model = torch_make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, cfg, device="cpu")
    return cfg, spec, model, trained()


def test_quantize_nl_params_matches_jax(flagship):
    """Every int8 tensor equals JAX's; scales, biases and bounds within f32
    round-off (rtol 1e-6); each padded operand is the zero-padded transpose."""
    cfg, spec, model, params = flagship
    got = tquant.quantize_nl_params(params, state_dim=N, action_dim=M, s_recon_terms=17)
    exp = jquant.quantize_nl_params(to_jax(params), state_dim=N, action_dim=M, s_recon_terms=17)

    def walk(g, e, path):
        if isinstance(e, dict):
            for k in e:
                walk(g[k], e[k], f"{path}/{k}")
            for k in set(g) - set(e):
                assert k.endswith("_mm"), k
                w = g[k.removesuffix("_mm")] if k != "wq_mm" else g["wq"]
                assert g[k].is_contiguous() and g[k].shape[0] % 8 == 0 and g[k].shape[1] % 8 == 0
                assert torch.equal(g[k][: w.shape[1], : w.shape[0]], w.T)
                assert int(g[k].abs().sum()) == int(w.abs().sum())  # the padding is zeros
        elif isinstance(e, list):
            for i, (a, b) in enumerate(zip(g, e)):
                walk(a, b, f"{path}/{i}")
        else:
            e = np.asarray(e)
            if e.dtype == np.int8:
                assert g.dtype == torch.int8
                np.testing.assert_array_equal(g.numpy(), e, err_msg=path)
            else:
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), e, rtol=1e-6, err_msg=path)

    walk(got, exp, "")


@pytest.mark.parametrize("kw", [
    {"fold_t": DT}, {}, {"quantize_gru": False, "mlp_int8_layers": (), "fold_t": DT},
    {"mlp_int8_layers": ()}, {"quantize_gru": False, "mlp_int8_layers": (1, 2)}],
    ids=["int8_fold", "int8", "fold_only", "gru_only", "mlp12"])
def test_int8_apply_matches_jax(flagship, kw):
    """The int8 apply against JAX's on 4,096 rows: the integer sums are exact
    in both, so they part only by f32 rounding around them and by the rare
    activation that lands on the other int8 step (relative gap median < 1e-6,
    max < 1e-2, above 1e-3 on under 1% of the outputs)."""
    cfg, spec, model, params = flagship
    obs, acts, ts = batch(4096, 2)
    jspec = jax_make_env(ENV, dt=DT).spec
    exp = np.asarray(jquant.quantized_apply_for("nl", ENV, to_jax(params), JConfig(), jspec, **kw)(None, obs, acts, ts))
    got = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, **kw)(
        None, *(torch.tensor(x) for x in (obs, acts, ts))).numpy()
    r = rel(got, exp)
    assert np.median(r) < 1e-6 and r.max() < 1e-2 and (r > 1e-3).mean() < 1e-2


def test_fold_only_matches_f32_apply(flagship):
    """tests/test_quant.py::test_fold_only_matches_f32_apply: the theta/phi
    fold with no int8 is the f32 apply (atol 5e-3, median < 1e-5)."""
    cfg, spec, model, params = flagship
    qa = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, quantize_gru=False, mlp_int8_layers=(),
                                    fold_t=float(cfg.dt))
    t_in = tuple(torch.tensor(x) for x in batch(512, 0))
    ref, out = model.apply(params, *t_in).numpy(), qa(None, *t_in).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)
    assert np.median(np.abs(out - ref)) < 1e-5


def test_gru_int8_near_lossless(flagship):
    """tests/test_quant.py::test_gru_int8_near_lossless: int8 on the GRU and
    its head alone, median abs error < 1e-3, 99th percentile < 2e-2."""
    cfg, spec, model, params = flagship
    qa = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, quantize_gru=True, mlp_int8_layers=())
    t_in = tuple(torch.tensor(x) for x in batch(1024, 1))
    err = np.abs(qa(None, *t_in).numpy() - model.apply(params, *t_in).numpy())
    assert np.median(err) < 1e-3 and np.percentile(err, 99) < 2e-2


def test_full_int8_fold_error_envelope(flagship):
    """tests/test_quant.py::test_full_int8_fold_error_envelope: the full int8
    (+fold) forward, median abs error < 0.05 and mean error under 10% of the
    outputs' spread."""
    cfg, spec, model, params = flagship
    qa = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, fold_t=float(cfg.dt))
    t_in = tuple(torch.tensor(x) for x in batch(4096, 2))
    ref, out = model.apply(params, *t_in).numpy(), qa(None, *t_in).numpy()
    err = np.abs(out - ref)
    assert np.median(err) < 0.05 and err.mean() / ref.std() < 0.10 and np.isfinite(out).all()


@pytest.mark.parametrize("rows", [1, 7, 17, 1000, 20000])
def test_int8_sums_exact_on_padded_shapes(flagship, rows):
    """``int8_matmul_int32`` through ``torch._int_mm`` with rows and widths
    padded to its sizes: int32 sums equal to the exact int64 product for
    every quantized matrix (k from 1 to 128, n from 2 to 170)."""
    _, _, _, params = flagship
    q = tquant.quantize_nl_params(params, state_dim=N, action_dim=M, s_recon_terms=17)
    mats = [(p[f"wq_{w}"], p[f"wq_{w}_mm"]) for p in q["gru"] for w in ("ih", "hh")]
    mats += [(q["enc_out"]["wq"], q["enc_out"]["wq_mm"])] + [(p["wq"], p["wq_mm"]) for p in q["mlp"]]
    g = torch.Generator().manual_seed(rows)
    for wq, wq_mm in mats:
        xq = torch.randint(-127, 128, (rows, wq.shape[0]), generator=g, dtype=torch.int8)
        got = tquant.int8_matmul_int32(xq, wq_mm)
        assert got.dtype == torch.int32 and got.shape == (rows, wq_mm.shape[0])
        assert torch.equal(got[:, : wq.shape[1]], (xq.long() @ wq.long()).int())


def test_int8_sums_take_an_int32_accumulator():
    """127 x 127 x 128 = 2,064,512 overflows int16: the sums are int32."""
    wq = torch.full((128, 8), 127, dtype=torch.int8)
    xq = torch.full((20, 128), -127, dtype=torch.int8)
    got = tquant.int8_matmul_int32(xq, tquant.pad_for_int_mm(wq))
    assert got.dtype == torch.int32 and bool((got == -127 * 127 * 128).all())


def test_int8_round_half_to_even():
    """Activations on a half step round to even, as jnp.round does."""
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5]]) / 127.0
    np.testing.assert_array_equal(tquant._quantize_acts(x, 1.0).numpy(),
                                  np.asarray(jquant._quantize_acts(jnp.asarray(x.numpy()), 1.0)))
    np.testing.assert_array_equal(tquant._quantize_acts(x, 1.0).numpy(), [[0, 2, 2, 0, -2]])


def test_int8_keeps_nan(flagship):
    """A NaN observation gives a NaN prediction in its row only."""
    cfg, spec, model, params = flagship
    qa = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, fold_t=float(cfg.dt))
    obs, acts, ts = (torch.tensor(x) for x in batch(8, 6))
    obs[3, 1] = float("nan")
    out = qa(None, obs, acts, ts)
    assert bool(torch.isnan(out[3]).all()) and bool(torch.isfinite(out[torch.arange(8) != 3]).all())
    acts[5, 2, 0] = float("nan")
    assert bool(torch.isnan(qa(None, obs, acts, ts)[5]).all())


def test_saturation_probe_matches_jax(flagship):
    """``planner_saturation_probe`` on JAX's action draw: the per-step clip
    fractions of the f32 rollout equal JAX's at obs bounds that clip."""
    cfg, spec, model, params = flagship
    jm = jax_make_model("nl", ENV, N, M, HIGH, JConfig(), dtype=jnp.float32)
    K, T = 64, 12
    key = jax.random.PRNGKey(1)
    acts = jax.random.uniform(key, (K, T, M), jnp.float32, minval=-1.0, maxval=1.0) * HIGH
    obs0 = np.array([0.1, 0.5, -1.0, 0.05, 0.3], np.float32)
    norm = norm_stats_for(ENV, HIGH, M)
    for bound in (6.0, [0.2, 0.2, 1.5, 1.5, 0.2]):
        exp = jquant.planner_saturation_probe(jm.apply, to_jax(params), norm, jnp.asarray(obs0), action_high=HIGH,
                                              action_dim=M, K=K, T=T, key=key, dt=DT, obs_bound=bound)
        got = tquant.planner_saturation_probe(model.apply, params, norm, torch.tensor(obs0), action_high=HIGH,
                                              action_dim=M, K=K, T=T, dt=DT, obs_bound=bound,
                                              actions=torch.tensor(np.asarray(acts)))
        assert got == exp
    assert got["clip_frac_max"] > 0.0


def test_int8_serving_controller_ticks(flagship):
    """tests/test_quant.py::test_int8_serving_controller_ticks: the int8
    apply drives the serving controller, 3 ticks of finite, in-range actions."""
    cfg, spec, model, params = flagship
    qapply = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, fold_t=float(cfg.dt))
    ctrl = tserving.make_controller("nl", ENV, DELAY, cfg, model_apply=qapply, params=params, roll_outs=64,
                                    time_steps=5, device="cpu")
    state = ctrl.reset(0)
    for _ in range(3):
        action, state = ctrl.step(state, torch.zeros(spec.n_obs))
        assert bool(torch.isfinite(action).all()) and float(action.abs().max()) <= spec.action_high + 1e-6


def test_int8_composes_with_k_sharded_planner(flagship):
    """tests/test_quant.py::test_int8_composes_with_k_sharded_planner: the
    int8 apply under ``evaluate_policy(shard_rollouts=True)`` (a world of one
    here) gives a finite return, equal to the unsharded run's."""
    cfg, spec, model, params = flagship
    qapply = tquant.quantized_apply_for("nl", ENV, params, cfg, spec, fold_t=float(cfg.dt))
    kw = dict(config=cfg, model_apply=qapply, params=params, roll_outs=64, time_steps=5, device="cpu")
    sharded = teval.evaluate_policy("nl", ENV, DELAY, [0], shard_rollouts=True, **kw)
    plain = teval.evaluate_policy("nl", ENV, DELAY, [0], **kw)
    assert np.isfinite(sharded["total_reward"]) and sharded["shard"] == "rollouts"
    assert sharded["total_rewards"] == plain["total_rewards"]


@pytest.mark.parametrize("model_name,cfg_kw", [("nl", {"encode_obs_time": True}), ("rnn", {})],
                         ids=["encode_obs_time", "not_nl"])
def test_quantized_apply_refuses(flagship, model_name, cfg_kw):
    """tests/test_quant.py::test_quantized_apply_rejects_encode_obs_time: the
    age channel is unbounded, and the route is NL's only (ValueError where
    the JAX package asserts)."""
    cfg, spec, model, params = flagship
    with pytest.raises(ValueError):
        tquant.quantized_apply_for(model_name, ENV, params, cfg.replace(**cfg_kw), spec)
