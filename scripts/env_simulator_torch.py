"""Environment viewer on the port: roll a random or oracle policy and write a
gif (the port's counterpart of ``scripts/env_simulator.py``).

    python3 scripts/env_simulator_torch.py [env] [policy] [n_steps] [--device cuda]

``policy`` is ``random`` or ``oracle`` (MPPI with K=200, T=30 on the closed
form dynamics, delay 0). Writes ``artifacts/port/sim_<env>_<policy>.gif``
(``--out_dir`` moves it). Rendering needs matplotlib and imageio; without them
it raises ``ImportError`` before the episode runs, as ``envs/render.py`` does.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(env_name="oderl-pendulum", policy="random", n_steps=100, device="cuda",
         out_dir=os.path.join(ROOT, "artifacts", "port")) -> str:
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env, render
    from neurallaplacecontrol_tpu_torch.planners import MPPIConfig, default_noise_sigma, make_mppi_params
    from neurallaplacecontrol_tpu_torch.training.rollout import (
        EpisodeSettings,
        SeedDraws,
        build_oracle_dynamics,
        make_episode_fn,
    )
    from neurallaplacecontrol_tpu_torch.utils.device import resolve_device

    render.require()
    device = resolve_device(device)
    cfg = Config()
    env = make_env(env_name)
    spec = env.spec
    mppi_cfg = MPPIConfig(num_samples=200, horizon=30, nu=spec.m, u_scale=spec.action_high,
                          u_min=-spec.action_high, u_max=spec.action_high)
    params = make_mppi_params(default_noise_sigma(spec.m, cfg.mppi_sigma, device=device))
    dyn = build_oracle_dynamics(env, spec.dt, 0) if policy == "oracle" else None
    settings = EpisodeSettings(delay=0, n_steps=int(n_steps), random_policy=policy == "random")
    episode = make_episode_fn(env, dyn, mppi_cfg, params, settings)
    total, rec = episode(SeedDraws([0], device=device))
    print(f"{env_name} {policy}: return {float(total[0]) * 200.0 / int(n_steps):.1f}")
    os.makedirs(out_dir, exist_ok=True)
    frames = render.render_episode(env, type(rec)(*(x[0] for x in rec)))
    path = render.save_video(frames, os.path.join(out_dir, f"sim_{spec.name}_{policy}.gif"), fps=int(1.0 / spec.dt))
    print("wrote", path)
    return path


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("env_name", nargs="?", default="oderl-pendulum")
    ap.add_argument("policy", nargs="?", default="random", choices=["random", "oracle"])
    ap.add_argument("n_steps", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out_dir", default=os.path.join(ROOT, "artifacts", "port"))
    a = ap.parse_args()
    main(a.env_name, a.policy, a.n_steps, a.device, a.out_dir)
