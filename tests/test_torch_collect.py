"""The port's expert-data collector (data.collector) and replay-buffer files
(data.replay) against the JAX package's: the same cache key, and files that
each package reads from the other. The collection itself runs at a tiny size
(K=8, T=3, 0.5 s steps) on the CPU."""

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.data import replay as jreplay
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.data import collector as tcollector
from neurallaplacecontrol_tpu_torch.data import replay as treplay
from neurallaplacecontrol_tpu_torch.envs import make_env
from neurallaplacecontrol_tpu_torch.planners import MPPIConfig, default_noise_sigma, make_mppi_params
from neurallaplacecontrol_tpu_torch.training import rollout as trollout

torch.set_num_threads(1)

ENV, DELAY = "oderl-pendulum", 1
SMALL = dict(dt=0.5, mppi_roll_outs=8, mppi_time_steps=3)


@pytest.mark.parametrize(
    "kw",
    [{}, {"encode_obs_time": True, "ts_grid": "fixed"},
     {"random_action_noise": None, "observation_noise": 0.01, "friction": True, "action_buffer_size": 6}],
    ids=["defaults", "encode_fixed", "noise_friction"],
)
def test_replay_buffer_filename_matches_jax(kw):
    for env_name, delay in ((ENV, DELAY), ("oderl-acrobot", 3)):
        assert treplay.replay_buffer_filename(env_name, delay, **kw) == jreplay.replay_buffer_filename(
            env_name, delay, **kw)


def test_collected_buffer_is_cached_and_jax_reads_it(tmp_path):
    cfg = TConfig(offline_datasets_path=str(tmp_path), **SMALL)
    n_steps = int(10.0 / cfg.dt)
    s0, a0, sn, ts = tcollector.collect_expert_data(ENV, DELAY, cfg, collect_samples=3 * n_steps,
                                                    chunk_episodes=2, device="cpu")
    # 3 episodes in chunks of 2 and 1
    assert s0.shape == (3 * n_steps, 3) and a0.shape == (3 * n_steps, 4, 1)
    assert sn.shape == (3 * n_steps, 3) and ts.shape == (3 * n_steps, 1)
    assert all(bool(torch.isfinite(x).all()) for x in (s0, a0, sn, ts))
    assert float(ts.std()) > 0 and float(ts.min()) > 0  # the exp grid is irregular
    assert float(a0.abs().max()) <= 2.0  # exploration noise is clipped to the bounds

    name = jreplay.replay_buffer_filename(ENV, DELAY)
    # the .npz and its native .rbuf sibling, as the JAX package writes them
    assert sorted(p.name for p in tmp_path.iterdir()) == [name, name.replace(".npz", ".rbuf")]
    for got, exp in zip(jreplay.load_replay_buffer(str(tmp_path / name)), (s0, a0, sn, ts)):
        np.testing.assert_array_equal(np.asarray(got), exp.numpy())

    # a second call reads the cache; force_new collects again from the same seeds
    cached = tcollector.collect_expert_data(ENV, DELAY, cfg, collect_samples=3 * n_steps, device="cpu")
    fresh = tcollector.collect_expert_data(ENV, DELAY, cfg, collect_samples=3 * n_steps,
                                           chunk_episodes=2, force_new=True, device="cpu")
    for c, f, x in zip(cached, fresh, (s0, a0, sn, ts)):
        assert torch.equal(c, x) and torch.equal(f, x)


def test_collector_episodes_are_seeded_episodes(tmp_path):
    """Episode i of a collection is the seed-batched episode drawing from
    ``episode_seed(seed, i)``, with the collector's exploration noise."""
    cfg = TConfig(offline_datasets_path=str(tmp_path), collect_expert_ts_grid="fixed", **SMALL)
    n_steps = int(10.0 / cfg.dt)
    s0, a0, _, _ = tcollector.collect_expert_data(ENV, DELAY, cfg, collect_samples=2 * n_steps,
                                                  seed=5, device="cpu")
    env = make_env(ENV, dt=cfg.dt)
    mcfg = MPPIConfig(num_samples=8, horizon=3, nu=1, u_scale=2.0, u_min=-2.0, u_max=2.0, dt=cfg.dt)
    params = make_mppi_params(default_noise_sigma(1, 1.0))
    settings = trollout.EpisodeSettings(delay=DELAY, n_steps=n_steps, explore_noise=1.0)
    episode = trollout.make_episode_fn(env, trollout.build_oracle_dynamics(env, cfg.dt, DELAY), mcfg,
                                       params, settings)
    seeds = [tcollector.episode_seed(5, i) for i in range(2)]
    assert len(set(seeds)) == 2 and seeds != [tcollector.episode_seed(6, i) for i in range(2)]
    _, rec = episode(trollout.SeedDraws(seeds, device="cpu"))
    assert torch.equal(rec.s0.reshape(-1, 3), s0) and torch.equal(rec.a0.reshape(-1, 4, 1), a0)


def test_port_reads_jax_buffer_and_drops_stale_native_sibling(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((10, 3), (10, 4, 1), (10, 3), (10, 1))]
    path = tmp_path / "buf.npz"
    jreplay.save_replay_buffer(str(path), *arrays)
    for got, exp in zip(treplay.load_replay_buffer(path, device="cpu"), arrays):
        np.testing.assert_array_equal(got.numpy(), exp)
    # a stale native sibling would shadow the new file for the JAX loader
    stale = tmp_path / "buf.rbuf"
    stale.write_bytes(b"stale")
    new = [a + 1.0 for a in arrays]
    treplay.save_replay_buffer(path, *(torch.as_tensor(a) for a in new))
    # the stale sibling is gone: the port writes a fresh one, as the JAX package does
    assert stale.read_bytes() != b"stale"
    for got, exp in zip(jreplay.load_replay_buffer(str(path)), new):
        np.testing.assert_array_equal(np.asarray(got), exp)
