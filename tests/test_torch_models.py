"""Port NL model (neurallaplacecontrol_tpu_torch.models) against the JAX
package's models.make_model("nl") apply, on the 12 tracked checkpoints."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.base import norm_stats_for as jax_norm_stats_for
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for as torch_norm_stats_for
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params, load_pytree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NL_CHECKPOINTS = sorted(p.name for p in (REPO / "artifacts" / "checkpoints").glob("nl_*.npz"))
ENV_DIMS = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
_JAX_APPLY = {}  # (env, dtype, config) -> jitted JAX apply, shared across the four delays


def env_of(name: str) -> str:
    return next(e for e in ENV_DIMS if name.startswith(f"nl_{e}_"))


def jax_apply(env, dtype, cfg=JConfig()):
    key = (env, dtype, cfg)
    if key not in _JAX_APPLY:
        n, m, high = ENV_DIMS[env]
        model = jax_make_model("nl", env, n, m, high, cfg, dtype=dtype)
        _JAX_APPLY[key] = (model, jax.jit(model.apply))
    return _JAX_APPLY[key]


def config_for(tparams, m, **kw):
    """pendulum delay 0 was trained with the age channel (GRU input m + 1)."""
    encode = tparams["encoder"]["gru"][0]["w_ih"].shape[0] == m + 1
    return JConfig(encode_obs_time=encode, **kw), TConfig(encode_obs_time=encode, **kw)


def inputs(env, B=64, seed=0, in_extra=0, ts=None):
    n, m, high = ENV_DIMS[env]
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, n))
    abuf = rng.uniform(-high, high, (B, 4, m + in_extra))
    if in_extra:
        abuf[..., -1] = np.abs(abuf[..., -1]) * 0.05  # age channel
    if ts is None:  # exp grid, some below the query-time floor
        ts = rng.exponential(0.05, (B, 1))
    else:
        ts = np.full((B, 1), ts)
    return obs, abuf, ts


def run_both(env, jparams, tparams, obs, abuf, ts, dtype, cfg=JConfig(), tcfg=TConfig()):
    n, m, high = ENV_DIMS[env]
    jdtype, tdtype = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    _, japply = jax_apply(env, jdtype, cfg)
    exp = np.asarray(japply(jparams, *(jnp.asarray(x, jdtype) for x in (obs, abuf, ts))))
    tmodel = torch_make_model("nl", env, n, m, high, tcfg, dtype=tdtype, device="cpu")
    got = tmodel.apply(tparams, *(torch.tensor(x, dtype=tdtype) for x in (obs, abuf, ts))).numpy()
    return got, exp


@pytest.mark.parametrize("name", NL_CHECKPOINTS)
def test_nl_apply_matches_jax_f64(name):
    env = env_of(name)
    tparams = load_pytree(REPO / "artifacts" / "checkpoints" / name, device="cpu", dtype=torch.float64)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jcfg, tcfg = config_for(tparams, ENV_DIMS[env][1])
    got, exp = run_both(env, jparams, tparams, *inputs(env, in_extra=int(jcfg.encode_obs_time)),
                        "f64", jcfg, tcfg)
    # atol: the fourier series sums terms up to ~1e2 in size into outputs
    # that can be ~1e-3, so f64 rounding leaves ~1e-12 absolute
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", NL_CHECKPOINTS)
def test_nl_apply_matches_jax_f32(name):
    """At the planner's query time t = dt. (Near the 2.5e-3 query-time floor
    the fourier prefactor e^{sigma t}/T reaches ~2e5, and f32 rounding alone
    moves both packages' outputs by several percent; the f64 test covers
    those times.)"""
    env = env_of(name)
    tparams = load_pytree(REPO / "artifacts" / "checkpoints" / name, device="cpu")
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jcfg, tcfg = config_for(tparams, ENV_DIMS[env][1])
    obs_abuf_ts = inputs(env, seed=1, in_extra=int(jcfg.encode_obs_time), ts=jcfg.dt)
    got, exp = run_both(env, jparams, tparams, *obs_abuf_ts, "f32", jcfg, tcfg)
    rel = np.abs(got - exp) / (1.0 + np.abs(exp))
    assert rel.max() < 1e-2, rel.max()


@pytest.mark.parametrize(
    "overrides",
    [dict(encode_obs_time=True), dict(normalize=False), dict(normalize_time=False)],
    ids=["encode_obs_time", "no_normalize", "no_normalize_time"],
)
def test_nl_apply_config_variants_match_jax_f64(overrides):
    """Freshly initialized JAX weights carried over by from_jax_params: the
    age channel, normalize=False and normalize_time=False branches."""
    env = "oderl-acrobot"
    n, m, high = ENV_DIMS[env]
    cfg = JConfig(**overrides)
    model, _ = jax_apply(env, jnp.float64, cfg)
    jparams = model.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    extra = 1 if overrides.get("encode_obs_time") else 0
    got, exp = run_both(env, jparams, tparams, *inputs(env, in_extra=extra), "f64", cfg,
                        TConfig(**overrides))
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_norm_stats_match_jax(env):
    n, m, high = ENV_DIMS[env]
    j, t = jax_norm_stats_for(env, high, m), torch_norm_stats_for(env, high, m)
    for field in ("state_mean", "state_std", "action_mean", "action_std"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))


def test_unported_models_raise():
    """What was refused before reference-weight import and bf16 were ported
    now builds (``latent_ode_ref``; NL with ``nl_compute_dtype="bfloat16"``,
    whose tree is the f32 model's), and so does the fused forward at the
    widths it refused (24, 160); an unknown name or compute dtype raises,
    and so does the fused forward for another ILT than fourier."""
    lor = torch_make_model("latent_ode_ref", "oderl-pendulum", 3, 1, 2.0, device="cpu")
    assert lor.name == "latent_ode_ref" and lor.latents == 5 and lor.rec_dims == 20
    bf16 = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    f32 = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, device="cpu")
    shapes = [[(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(m.init(torch.Generator().manual_seed(0)))]
              for m in (bf16, f32)]
    assert shapes[0] == shapes[1]
    with pytest.raises(ValueError, match="Unknown model"):
        torch_make_model("latent_ode_refs", "oderl-pendulum", 3, 1, 2.0, device="cpu")
    with pytest.raises(ValueError, match="nl_compute_dtype"):
        torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(nl_compute_dtype="float16"), device="cpu")
    # the fused planner forward takes the fourier ILT only
    model = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(nl_ilt_algorithm="dehoog"),
                             device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="fourier-only"):
        model.make_fused_planner_apply(params, 0.05)
    # at any width: GRU 12 (padded to 16) and GRU 80 (past the resident kernel's 64) agree with
    # JAX's fused kernel in interpret mode on JAX's init, at tests/test_torch_kernels.py's 1e-2
    obs, abuf, ts = (x.astype(np.float32) for x in inputs("oderl-pendulum", B=16, ts=0.05))
    for hidden in (24, 160):
        jmodel = jax_make_model("nl", "oderl-pendulum", 3, 1, 2.0, JConfig(nl_hidden_units=hidden),
                                dtype=jnp.float32)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        with pltpu.force_tpu_interpret_mode():
            exp = np.asarray(jmodel.make_fused_planner_apply(jparams, 0.05)(None, obs, abuf, ts), np.float64)
        model = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(nl_hidden_units=hidden),
                                 device="cpu")
        fused = model.make_fused_planner_apply(from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                                               device="cpu"), 0.05)
        got = fused(None, *(torch.tensor(x) for x in (obs, abuf, ts))).double().numpy()
        assert got.shape == (16, 3)
        assert float((np.abs(got - exp) / (1.0 + np.abs(exp))).max()) < 1e-2


@pytest.mark.parametrize("hidden", [16, 48, 128])
@pytest.mark.parametrize("encode_obs_time", [False, True])
def test_init_matches_jax_tree(hidden, encode_obs_time):
    """The port's init has JAX's keys, shapes and dtypes; its values lie in
    the JAX distributions' bounds (xavier for linear weights, 1/sqrt(in)
    for linear biases, 1/sqrt(H) for the GRU); count_params agrees."""
    from neurallaplacecontrol_tpu.models import count_params as jax_count_params
    from neurallaplacecontrol_tpu.utils.checkpoint import _flatten
    from neurallaplacecontrol_tpu_torch.models import count_params
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import flatten_params

    env = "oderl-acrobot"
    n, m, high = ENV_DIMS[env]
    kw = dict(nl_hidden_units=hidden, encode_obs_time=encode_obs_time)
    jparams = jax_make_model("nl", env, n, m, high, JConfig(**kw), dtype=jnp.float64).init(jax.random.PRNGKey(0))
    tmodel = torch_make_model("nl", env, n, m, high, TConfig(**kw), dtype=torch.float64, device="cpu")
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jflat, tflat = _flatten(jparams), flatten_params(tparams)
    assert sorted(jflat) == sorted(tflat)
    for key, exp in jflat.items():
        got = tflat[key]
        assert got.shape == exp.shape and got.dtype == exp.dtype, key
        fan_in = got.shape[0]
        if "gru" in key:
            bound = 1.0 / np.sqrt(tparams["encoder"]["gru"][0]["w_hh"].shape[0])
        elif key.endswith("/w"):
            bound = np.sqrt(6.0 / (got.shape[0] + got.shape[1]))
        else:  # a linear bias: bound from its layer's weight
            fan_in = tflat[key[:-1] + "w"].shape[0]
            bound = 1.0 / np.sqrt(fan_in)
        assert np.abs(got).max() <= bound, key
        if got.size >= 64:  # enough draws to reach the top half of the range
            assert np.abs(got).max() > 0.5 * bound, key
    assert count_params(tparams) == jax_count_params(jparams)
    # the same generator seed gives the same init; another seed another
    again = tmodel.init(torch.Generator().manual_seed(0))
    other = tmodel.init(torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(flatten_params(again)["laplace_rep/0/w"], tflat["laplace_rep/0/w"])
    assert not np.array_equal(flatten_params(other)["laplace_rep/0/w"], tflat["laplace_rep/0/w"])


@pytest.mark.parametrize("algorithm", ["fourier", "dehoog", "stehfest", "fixed_talbot", "euler", "cme"])
def test_nl_apply_every_ilt_matches_jax_f64(algorithm):
    """A narrow NL (nl_hidden_units=16) under each ILT, JAX's init carried
    over by from_jax_params: cme snaps its terms (17 -> 15) in both. At query
    times around dt; rtol 1e-9, atol 1e-9 (stehfest: 1e-5 of the largest
    output, the rounding of its 3.6e9-weight sum in another order)."""
    env = "oderl-pendulum"
    n, m, high = ENV_DIMS[env]
    cfg = JConfig(nl_hidden_units=16, nl_ilt_algorithm=algorithm)
    model, japply = jax_apply(env, jnp.float64, cfg)
    jparams = model.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert tparams["laplace_rep"][-1]["w"].shape == jparams["laplace_rep"][-1]["w"].shape
    obs, abuf, _ = inputs(env, B=32, seed=4)
    ts = np.random.default_rng(5).uniform(0.02, 0.1, (32, 1))
    got, exp = run_both(env, jparams, tparams, obs, abuf, ts, "f64", cfg,
                        TConfig(nl_hidden_units=16, nl_ilt_algorithm=algorithm))
    assert np.all(np.isfinite(got))
    if algorithm == "stehfest":
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5 * np.abs(exp).max())
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9)


def test_cme_terms_match_jax():
    from neurallaplacecontrol_tpu.config import cme_reconstruction_terms as jterms
    from neurallaplacecontrol_tpu.config import snap_cme_terms as jsnap
    from neurallaplacecontrol_tpu_torch.config import cme_reconstruction_terms, snap_cme_terms

    assert cme_reconstruction_terms() == jterms()
    for terms in (5, 16, 17, 33, 100, 217, 600):
        assert snap_cme_terms(terms) == jsnap(terms)


def test_config_fields_match_jax_defaults():
    """The port's Config keeps JAX Config fields, by name and default."""
    jcfg, tcfg = JConfig(), TConfig()
    for field in tcfg.__dataclass_fields__:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
