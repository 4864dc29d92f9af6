"""Held-out one-step MSE of the port's node, latent_ode and nl on the shared
cartpole-d1 expert buffer (the port's counterpart of
``scripts/heldout_parity.py``).

    python3 scripts/heldout_parity_torch.py [--ckpt_dir artifacts/checkpoints/] [--models node,latent_ode,nl]
        [--device cuda]

The metric of the JAX script, on the same 256 rows: the rows are
``torch.randperm(N, generator=manual_seed(1234))[:256]`` of the tracked
buffer ``artifacts/offlinedata/...cartpole_delay-1...npz``. For node and nl it
is the mean squared error of ``apply(s0, a0, ts)`` against ``sn - s0``. For the
latent ODE it is the planner-facing mean prediction over the history windows
the reference's forward uses (the s0 rows unfolded, window = action buffer),
the mean of ``predict_diff`` over 8 draws of z0's noise (``eps``, from a
``torch.Generator`` seeded 7 unless given). The weights are the tracked
checkpoints of ``--ckpt_dir``. Appends one line per model, with the card, to
``--out`` (``artifacts/port/heldout_parity_h100.log``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BUF = (
    REPO / "artifacts" / "offlinedata" / "replay_buffer_env-name-oderl-cartpole_delay-1_"
    "model-name-oracle_encode-obs-time-False_action-buffer-size-4_ts-grid-exp_"
    "random-action-noise-1.0_observation-noise-0.0_friction-False.npz"
)
OUT = REPO / "artifacts" / "port" / "heldout_parity_h100.log"
ENV, DELAY, ROWS, IWAE_DRAWS = "oderl-cartpole", 1, 256, 8


def read_buffer(path=BUF) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in ("s0", "a0", "sn", "ts")}


def heldout_index(n: int) -> np.ndarray:
    import torch

    return torch.randperm(n, generator=torch.Generator().manual_seed(1234))[:ROWS].numpy()


def heldout_mse(model_name: str, model, params, data: dict, device, eps=None, dtype=None) -> float:
    """The mean over the held-out rows of each row's mean squared error.
    ``eps`` [8, 256, latents] is the latent ODE's draw of z0's noise; the
    inputs go in at ``dtype`` (float32 by default), the model's."""
    import torch

    s0, a0, sn, ts = (data[k] for k in ("s0", "a0", "sn", "ts"))
    dtype = dtype or torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    n_obs = s0.shape[1]
    with torch.no_grad():
        if model_name == "latent_ode":
            # the reference harness's windowing and index space
            absize = a0.shape[1]
            idx = heldout_index(s0.shape[0] - (absize - 1))
            win = np.stack([np.arange(i, i + absize) for i in idx])  # [256, A]
            if eps is None:
                eps = torch.randn((IWAE_DRAWS, ROWS, model.latents), generator=torch.Generator().manual_seed(7))
            outs, _ = model.predict_diff(params, t(eps), t(s0[win]), t(a0[:, -1, :][win]), t(ts[idx]))
            pred = outs.mean(0)[:, :n_obs].double().cpu().numpy()
            target = sn[idx] - s0[idx + absize - 1]
        else:
            idx = heldout_index(s0.shape[0])
            pred = model.apply(params, t(s0[idx]), t(a0[idx]), t(ts[idx])).double().cpu().numpy()
            target = sn[idx] - s0[idx]
    return float(np.mean(np.mean((pred - target) ** 2, axis=1)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", type=str, default="artifacts/checkpoints/")
    ap.add_argument("--models", type=str, default="node,latent_ode,nl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name
    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(args.device)
    where = card(device)
    data = read_buffer()
    spec = make_env(ENV).spec
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    results = {}
    with open(args.out, "a", buffering=1) as out:
        for model_name in args.models.split(","):
            ckpt = REPO / args.ckpt_dir / model_checkpoint_name(model_name, ENV, DELAY, "exp", 0, True)
            model = make_model(model_name, ENV, spec.n_obs, spec.m, spec.action_high, Config(), device=device)
            params = load_pytree(str(ckpt), device=device)
            results[model_name] = heldout_mse(model_name, model, params, data, device)
            line = (f"port {model_name} ({args.ckpt_dir}; {where['device']}, {where['power_limit_w']} W): "
                    f"heldout_mse={results[model_name]:.6f} over {ROWS} samples")
            print(line, flush=True)
            out.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
