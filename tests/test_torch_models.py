"""Port NL model (neurallaplacecontrol_tpu_torch.models) against the JAX
package's models.make_model("nl") apply, on the 12 tracked checkpoints."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    with pytest.raises(NotImplementedError):
        torch_make_model("rnn", "oderl-pendulum", 3, 1, 2.0, device="cpu")
    with pytest.raises(NotImplementedError):
        torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0,
                         TConfig(nl_compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError):
        torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0,
                         TConfig(nl_ilt_algorithm="dehoog"), device="cpu")


def test_config_fields_match_jax_defaults():
    """The port's Config keeps JAX Config fields, by name and default."""
    jcfg, tcfg = JConfig(), TConfig()
    for field in tcfg.__dataclass_fields__:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
