"""Port synthetic data and oracle validation (neurallaplacecontrol_tpu_torch.data)
against the JAX package's data.synthetic / data.validation, with JAX's
random draws replayed into the port through the ``SyntheticDraws`` methods."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.data import synthetic as jsyn
from neurallaplacecontrol_tpu.data import validation as jval
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.envs import sample_dt as jax_sample_dt
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.data import synthetic as tsyn
from neurallaplacecontrol_tpu_torch.data import validation as tval
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.envs.oracle import ORACLES
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


class JaxSyntheticDraws:
    """The JAX generator's draws (data/synthetic.py ``_generate``): its key
    split into ``rounds + 3`` keys, a state and an action key per round,
    then the interval, buffer and observation-noise keys."""

    def __init__(self, key, rounds, dtype=torch.float64):
        self.keys = jax.random.split(key, rounds + 3)
        self.rounds, self.dtype, self.device = rounds, dtype, torch.device("cpu")

    def _t(self, x):
        return torch.tensor(np.asarray(x), dtype=self.dtype)

    def states_actions(self, rounds, n_states, state_dim, n_actions, action_dim, shared):
        assert rounds == self.rounds
        u_s, u_a = [], []
        for k in self.keys[: 1 if shared else rounds]:
            k_s, k_a = jax.random.split(k)
            u_s.append(jax.random.uniform(k_s, (n_states, state_dim)))
            u_a.append(jax.random.uniform(k_a, (n_actions, action_dim)))
        return self._t(np.stack(u_s)), self._t(np.stack(u_a))

    def dt(self, ts_grid, dt, rounds):
        return self._t(jax_sample_dt(self.keys[rounds], ts_grid, dt, (rounds,)))

    def buffer(self, n, size, action_dim):
        return self._t(jax.random.uniform(self.keys[self.rounds + 1], (n, size, action_dim)))

    def obs_noise(self, n, n_obs):
        return self._t(jax.random.normal(self.keys[self.rounds + 2], (n, n_obs)))


CASES = {  # env, delay, rand, reuse, encode_obs_time, obs noise, ts_grid
    "pendulum_d1_rand": ("oderl-pendulum", 1, True, False, False, 0.0, "exp"),
    "pendulum_d2_grid": ("oderl-pendulum", 2, False, False, False, 0.0, "exp"),
    "acrobot_d0_reuse": ("oderl-acrobot", 0, True, True, False, 0.0, "uniform"),
    "cartpole_d1_ages_noise": ("oderl-cartpole", 1, True, False, True, 0.1, "exp"),
    "acrobot_d3_grid_fixed": ("oderl-acrobot", 3, False, False, False, 0.0, "fixed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_matches_jax_f64(case):
    """Fed JAX's draws, the port's generator equals JAX's at f64 (rtol and
    atol 1e-12: the same operations, the grid's linspace aside)."""
    env_name, delay, rand, reuse, encode, noise, grid = CASES[case]
    spd = 3
    kw = dict(delay=delay, samples_per_dim=spd, rand=rand, action_buffer_size=4,
              encode_obs_time=encode, reuse_state_actions_when_sampling_times=reuse)
    key = jax.random.PRNGKey(7)
    exp = jsyn.generate_irregular_data_delay_time_multi(jax_make_env(env_name, ts_grid=grid, noise=noise), key, **kw)
    draws = JaxSyntheticDraws(key, spd * 10)
    got = tsyn.generate_irregular_data_delay_time_multi(torch_make_env(env_name, ts_grid=grid, noise=noise),
                                                        draws, **kw)
    for name, g, e in zip(("s0", "a0", "sn", "ts"), got, exp):
        assert g.shape == e.shape and g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12, atol=1e-12, err_msg=name)
    s0, a0, sn, ts = got
    if noise == 0.0:  # sn is one oracle step of s0 under the action at -(delay+1)
        pred = ORACLES[env_name](s0, a0, ts, delay)
        np.testing.assert_allclose(pred.numpy(), sn.numpy(), atol=1e-10)
    if encode:  # integer ages, the reference's quirk
        np.testing.assert_array_equal(a0[0, :, -1].numpy(), [3.0, 2.0, 1.0, 0.0])


def test_legacy_generators_match_jax_f64():
    key = jax.random.PRNGKey(3)
    jenv, tenv = jax_make_env("oderl-pendulum"), torch_make_env("oderl-pendulum")
    exp = jsyn.generate_irregular_data_delay(jenv, key, 2, samples_per_dim=3)
    got = tsyn.generate_irregular_data_delay(tenv, JaxSyntheticDraws(key, 30), 2, samples_per_dim=3)
    assert got[1].shape[1:] == (3, 1)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12, atol=1e-12)
    exp = jsyn.generate_irregular_data(jenv, key, samples_per_dim=3)
    got = tsyn.generate_irregular_data(tenv, JaxSyntheticDraws(key, 30), samples_per_dim=3)
    assert got[1].dim() == 2
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12, atol=1e-12)
    assert tsyn.default_samples_per_dim("oderl-cartpole") == jsyn.default_samples_per_dim("oderl-cartpole")


def test_seeded_draws_are_reproducible_and_shaped():
    env = torch_make_env("oderl-pendulum", ts_grid="exp")
    a = tsyn.generate_irregular_data_delay_time_multi(env, tsyn.SyntheticDraws(1, device="cpu"), 1, samples_per_dim=3)
    b = tsyn.generate_irregular_data_delay_time_multi(env, tsyn.SyntheticDraws(1, device="cpu"), 1, samples_per_dim=3)
    c = tsyn.generate_irregular_data_delay_time_multi(env, tsyn.SyntheticDraws(2, device="cpu"), 1, samples_per_dim=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    s0, a0, sn, ts = a
    assert s0.dtype == torch.float32 and a0.shape == (30 * 27, 4, 1) and ts.shape == (30 * 27, 1)
    assert float(ts.min()) > 0
    # the executed slot -(delay+1) differs from a distractor slot
    assert not torch.allclose(a0[:, -2, 0], a0[:, -1, 0])


def test_validation_loss_of_tracked_checkpoint_matches_jax_f64():
    """The oracle validation loss of the tracked pendulum-d1 NL, on JAX's
    PRNGKey(0) draws, equals JAX's at f64 (rtol 1e-9)."""
    env_name, delay = "oderl-pendulum", 1
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env_name, delay, "exp", 0, True)
    tparams = load_pytree(path, device="cpu", dtype=torch.float64)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jmodel = jax_make_model("nl", env_name, 3, 1, 2.0, JConfig(), dtype=jnp.float64)
    tmodel = torch_make_model("nl", env_name, 3, 1, 2.0, TConfig(), dtype=torch.float64, device="cpu")
    exp = jval.get_val_loss_delay_time_multi(jmodel.apply, jparams, jax_make_env(env_name), delay)
    got = tval.get_val_loss_delay_time_multi(tmodel.apply, tparams, torch_make_env(env_name), delay,
                                             draws=JaxSyntheticDraws(jax.random.PRNGKey(0), 50),
                                             device="cpu")
    assert 0 < got < 1e-2
    np.testing.assert_allclose(got, exp, rtol=1e-9)


def test_oracle_val_loss_helpers():
    """A 'model' that predicts the oracle's state difference scores ~0; an
    untrained NL scores finite and strictly worse (the port's counterpart of
    tests/test_data_train.py::test_oracle_val_loss_helpers)."""
    env = torch_make_env("oderl-pendulum")
    delay = 1
    draws = tsyn.SyntheticDraws(0, dtype=torch.float64, device="cpu")
    s0, a0, sn, ts = tval.compute_val_data_delay(env, delay, draws, samples_per_dim=3)
    assert s0.shape[0] == a0.shape[0] == sn.shape[0] == ts.shape[0]
    assert torch.all(ts == 0.05)

    def oracle_apply(params, s0, a0, ts):
        return ORACLES["pendulum"](s0, a0, ts, delay) - s0

    assert tval.get_val_loss_delay_precomputed(oracle_apply, None, s0, a0, sn, ts) < 1e-20
    model = torch_make_model("nl", "oderl-pendulum", 3, 1, 2.0, TConfig(nl_hidden_units=16),
                             dtype=torch.float64, device="cpu")
    loss = tval.get_val_loss_delay_time_multi(model.apply, model.init(torch.Generator().manual_seed(0)), env,
                                              delay, samples_per_dim=3, dtype=torch.float64, device="cpu")
    assert np.isfinite(loss) and loss > 1e-8


class JaxLatentDraws:
    """The JAX latent generator's draws (data/synthetic.py:130-216): its key
    split into one key per round, each split 3 ways into the state, action
    and time-grid keys, and the extra actions from ``fold_in(key, 7)``."""

    def __init__(self, key, rounds, dtype=torch.float64):
        self.key, self.dtype, self.device = key, dtype, torch.device("cpu")
        self.round_keys = [jax.random.split(k, 3) for k in jax.random.split(key, rounds)]

    def _t(self, x):
        return torch.tensor(np.asarray(x), dtype=self.dtype)

    def states_actions(self, rounds, n_states, state_dim, n_actions, action_dim, shared):
        assert rounds == len(self.round_keys) and not shared
        return (self._t(np.stack([jax.random.uniform(k[0], (n_states, state_dim)) for k in self.round_keys])),
                self._t(np.stack([jax.random.uniform(k[1], (n_actions, action_dim)) for k in self.round_keys])))

    def grid_dts(self, ts_grid, dt, rounds):
        return self._t(np.stack([jax_sample_dt(k[2], ts_grid, dt, (3,)) for k in self.round_keys]))

    def buffer(self, n, size, action_dim):
        return self._t(jax.random.uniform(jax.random.fold_in(self.key, 7), (n, size, action_dim)))


LATENT_CASES = {  # env, delay, rand, latent, ts_grid
    "cartpole_latent_d2": ("oderl-cartpole", 2, True, True, "exp"),
    "cartpole_latent_d0_grid_fixed": ("oderl-cartpole", 0, False, True, "fixed"),
    "pendulum_d1_uniform": ("oderl-pendulum", 1, True, False, "uniform"),
    "acrobot_d0_grid": ("oderl-acrobot", 0, False, False, "exp"),
}


@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_latent_generator_matches_jax_f64(case):
    """``generate_irregular_data_delay_latent`` on JAX's draws, < 1e-12 at
    f64; ``ts`` is the second absolute grid point, the JAX package's quirk,
    and with ``latent`` sn is the two-frame oracle's step from (s0, sb)."""
    env_name, delay, rand, latent, grid = LATENT_CASES[case]
    key, spd = jax.random.PRNGKey(12), 3
    kw = dict(samples_per_dim=spd, rand=rand, latent=latent)
    exp = jsyn.generate_irregular_data_delay_latent(jax_make_env(env_name, ts_grid=grid), key, delay, **kw)
    got = tsyn.generate_irregular_data_delay_latent(torch_make_env(env_name, ts_grid=grid),
                                                    JaxLatentDraws(key, spd), delay, **kw)
    for name, g, e in zip(("s0", "a0", "sb", "sn", "ts"), got, exp):
        assert g.shape == e.shape and g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-12, atol=1e-12, err_msg=name)
    if latent:
        assert got[0].shape[1] == 3
    with pytest.raises(ValueError, match="cartpole-only"):
        tsyn.generate_irregular_data_delay_latent(torch_make_env("oderl-pendulum"), JaxLatentDraws(key, spd), 0,
                                                  samples_per_dim=spd, latent=True)


def test_latent_generator_own_draws():
    s0, a0, sb, sn, ts = tsyn.generate_irregular_data_delay_latent(
        torch_make_env("oderl-cartpole", ts_grid="exp"), tsyn.SyntheticDraws(0, torch.float64, "cpu"), 1,
        samples_per_dim=2, rand=True, latent=True)
    assert s0.shape == sb.shape == sn.shape == (64, 3) and a0.shape == (64, 2, 1) and ts.shape == (64, 1)
    assert bool(torch.isfinite(sn).all()) and bool((ts > 0).all())
