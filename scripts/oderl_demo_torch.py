"""ODE-RL demo on the port: collect -> fit ENODE dynamics -> learn a policy
(the counterpart of ``scripts/oderl_demo.py``; reference envs/oderl/runner.py).

    python3 scripts/oderl_demo_torch.py [--env oderl-pendulum] [--dynamics enode] [--device cuda]
        [--out artifacts] [--seed 0]

The JAX demo's flow and sizes: 8 exploration trajectories of 2 s, 300
updates of ``gradient_match``, 200 of ``train_dynamics`` (16 segments), 100
of ``train_policy`` (1 s imagined horizon, 32 initial states, 5 draws), on
an ensemble of 5 nets 2x64 with a 2x32 policy and value net. Then it saves
the CTRL as ``<out>/ctrl_<name>.npz`` (the JAX package's format) and rolls
the learned model and the true env out under the learned policy; the
comparison is plotted to ``<out>/oderl_<name>_rollout.png`` when matplotlib
is installed. ``main`` returns each trainer's losses and wall time.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

logger = logging.getLogger("oderl_demo_torch")

SIZES = dict(n_ens=5, nl_f=2, nn_f=64, nn_g=32, nn_V=32)  # scripts/oderl_demo.py
GM = dict(n_iter=300, lr=3e-3)
DYN = dict(n_iter=200, n_seg=16)
POL = dict(n_iter=100, H=1.0, N=32, L=5)


def _timed(device, fn, *args, **kw):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def imagined_return(ctrl, params, D, H: float, tau: float = 5.0) -> float:
    """The policy's mean discounted reward rate under the learned ensemble
    from every state of D (the quantity ``train_policy`` reports, on a fixed
    set of states, so two policies compare on the same rollouts)."""
    with torch.no_grad():
        _, rt, _ = ctrl.forward_simulate(params, torch.Generator(device=ctrl.device).manual_seed(0), H,
                                         D.s.reshape(-1, D.s.shape[-1]), L=ctrl.n_ens, tau=tau, compute_rew=True,
                                         substeps=5)
    return float(torch.mean(rt[:, :, -1]) / H)


def main(env_name="oderl-pendulum", dynamics="enode", device="cuda", out="artifacts", seed=0, sizes=None,
         gm=None, dyn=None, pol=None) -> dict:
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.oderl import (
        collect_data,
        gradient_match,
        make_ctrl,
        train_dynamics,
        train_policy,
    )
    from neurallaplacecontrol_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    env = make_env(env_name)
    ctrl = make_ctrl(env, dynamics, device=dev, **(sizes or SIZES))
    g = torch.Generator(device=dev).manual_seed(seed)
    params = ctrl.init(g)

    D = collect_data(env, H=2.0, N=8, generator=g, device=dev)
    logger.info("collected %d trajectories of %d steps", D.N, D.T)
    result = {"name": ctrl.name}
    (params, losses), secs = _timed(dev, gradient_match, ctrl, params, D, g, **(gm or GM))
    result["gradient_match"] = {"losses": losses, "seconds": secs}
    logger.info("gradient match loss %.4f -> %.4f", losses[0], losses[-1])
    (params, mses), secs = _timed(dev, train_dynamics, ctrl, params, D, g, **(dyn or DYN))
    result["train_dynamics"] = {"losses": mses, "seconds": secs}
    logger.info("segment mse %.4f -> %.4f", mses[0], mses[-1])
    pol = pol or POL
    before = imagined_return(ctrl, params, D, pol["H"])
    (params, rewards), secs = _timed(dev, train_policy, ctrl, params, D, g, **pol)
    result["train_policy"] = {"losses": rewards, "seconds": secs,
                              "imagined_return": (before, imagined_return(ctrl, params, D, pol["H"]))}
    logger.info("imagined reward %.3f -> %.3f; on every stored state %.4f -> %.4f", rewards[0], rewards[-1],
                *result["train_policy"]["imagined_return"])

    os.makedirs(out, exist_ok=True)
    result["checkpoint"] = os.path.join(out, f"ctrl_{ctrl.name}.npz")
    ctrl.save(params, result["checkpoint"])

    # the learned model's rollout against the true env's under the learned policy
    raw = env.reset(g, device=dev)
    with torch.no_grad():
        st, _, ts = ctrl.forward_simulate(params, g, 2.0, env.observe(raw)[None], L=ctrl.n_ens)
        true = []
        for _ in range(st.shape[2]):
            obs = env.observe(raw)
            true.append(obs)
            raw = raw + env.spec.dt * env.rhs(raw, ctrl.policy_apply(params, obs[None])[0])
    result["rollout"] = {"learned": st[0, 0].cpu(), "true": torch.stack(true).cpu(), "ts": ts.cpu()}
    try:
        from neurallaplacecontrol_tpu_torch.results.plotting import plot_trajectories

        result["plot"] = plot_trajectories(ts, torch.stack(true), st[0], path=os.path.join(
            out, f"oderl_{ctrl.name}_rollout.png"), title=f"{ctrl.name}: learned (dashed) vs true")
        logger.info("wrote %s", result["plot"])
    except ImportError:
        logger.info("matplotlib is not installed: no rollout plot")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="oderl-pendulum")
    ap.add_argument("--dynamics", default="enode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(a.env, a.dynamics, a.device, a.out, a.seed)
