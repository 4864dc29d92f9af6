"""The numerics behind the port's training checks in ``chip_smoke.py``.

    python scripts/port_train_numerics.py gaps [cpu|cuda]   # the port's training against the JAX run
    python3 scripts/port_train_numerics.py kernel           # GPU: the forward kernel on early weights
    python3 scripts/port_train_numerics.py timing OLD.cu    # GPU: the forward kernel against an older source

``gaps`` runs ``chip_smoke.train_against_jax`` on the device named (the CPU
by default): the port's first segment (250 updates) on the init, data and
batch order of ``artifacts/port/jax_train_pendulum_d1.npz``, in f32 and in
f64 against the JAX run of that dtype. In f32: once as recorded, three
times with the init moved up by one ulp in 1% of its weights (seeds 0-2)
and three times with every weight moved one ulp up or down (seeds 3-5). In
f64: as recorded and with the init moved (seeds 0 and 3). Then the planted
wrong runs of ``PLANTED`` in both dtypes. Each run prints its gaps and the
first update whose loss is more than 1e-9, 1e-6, 1e-4 and 1e-2 (relative)
from JAX's; ``chip_smoke.py``'s limits were set from these lines.

``kernel`` builds the forward kernel from ``csrc/nl_kernels.cu`` as it is
and with each planted fault of ``FAULTS`` (in a copy of the source in a
temporary directory). Each build checks the head kernel as phase ``kernels``
does, and puts the forward kernel beside the plain forward at f32 and f64
(``chip_smoke.forward_errors``) on six weight sets: the JAX run's init and
its weights after 250 updates, the tracked d1 checkpoints of the three
envs, and weights that ``train_model`` trains on the card for 4 epochs of
20 collected episodes, as ``chip_smoke.py`` phase ``train`` does. Each mode
prints one JSON line per measurement.

``timing`` builds the forward kernel from ``OLD.cu`` (an older revision of
``csrc/nl_kernels.cu``, for example ``git show REV:neurallaplacecontrol_tpu_torch/
csrc/nl_kernels.cu``) and from the checkout's source, and times each in turns
(old, new, new, old) on cartpole's tracked d1 weights at 1,000 and 20,000
rows, 20 launches captured in one CUDA graph per reading (``chip_smoke.graph_ms``),
with each build's error against the plain forward.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import neurallaplacecontrol_tpu_torch as port  # noqa: E402
from neurallaplacecontrol_tpu_torch.envs import make_env  # noqa: E402
from neurallaplacecontrol_tpu_torch.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu_torch.models.common import tree_map  # noqa: E402
from neurallaplacecontrol_tpu_torch.ops import pallas_ilt, pallas_nl  # noqa: E402
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params  # noqa: E402

ENV, ROWS = "oderl-pendulum", (1000, 20000)
# wrong runs for ``gaps``: the learning rate or the clip norm 10% off
PLANTED = {"learning_rate": 1.1e-4, "clip_grad_norm": 0.11}


def gaps(device: str = "cpu") -> None:
    torch.set_num_threads(4)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = chip_smoke.read_jax_train_reference()
    cfg = port.Config()
    runs = [(seed, torch.float32, None) for seed in (None, 0, 1, 2, 3, 4, 5)]
    runs += [(seed, torch.float64, None) for seed in (None, 0, 3)]
    runs += [(None, dtype, {k: v}) for dtype in (torch.float32, torch.float64)
             for k, v in PLANTED.items()]
    for seed, dtype, fault in runs:
        run = dict(ref)
        if seed is not None:
            rng = np.random.default_rng(seed)

            def perturb(x):  # seeds 0-2: 1% of the weights one ulp up; 3-5: each one ulp up or down
                if seed < 3:
                    return np.where(rng.random(x.shape) < 0.01, np.nextafter(x, np.float32(np.inf)), x)
                return np.nextafter(x, np.where(rng.random(x.shape) < 0.5, -np.inf, np.inf).astype(np.float32))

            run["init"] = tree_map(perturb, ref["init"])
        r = chip_smoke.train_against_jax(run, device, dtype, cfg.replace(**fault) if fault else None)
        exp = ref["losses64"] if dtype == torch.float64 else ref["losses"]
        rel_gap = (np.abs(r["losses"] - exp) / np.abs(exp)).ravel()
        print(json.dumps({
            "mode": "gaps", "dtype": r["dtype"], "init_moved_seed": seed, "fault": fault,
            "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            **{k: r[k] for k in ("updates", "ms_per_update", "first_segment_rel_gap", "update_loss_rel_gap",
                                 "forward_rel_gap", "segment_mean_loss", "jax_segment_mean_loss")},
            "first_update_with_rel_gap_over": {f"{t:g}": int(np.argmax(rel_gap > t)) if (rel_gap > t).any()
                                               else None for t in (1e-9, 1e-6, 1e-4, 1e-2)},
        }), flush=True)
    if device == "cuda":
        print(chip_smoke.nvidia_smi(), flush=True)


# the kernel with a planted fault, as text replaced in a copy of the source
FAULTS = {
    "sound": (),
    # the head's angles through the fast, less accurate intrinsic
    "__sincosf": (("sincosf(phi,", "__sincosf(phi,"), ("sincosf(theta,", "__sincosf(theta,")),
    # one TF32 pass (hi * hi) where split TF32 takes three
    "one_pass_tf32": (("  mma_tf32(acc.lh, lo, b.hi[0], b.hi[1]);\n  mma_tf32(acc.hl, hi, b.lo[0], b.lo[1]);\n",
                       ""),),
}


def use_kernel_source(text: str, tmp: str) -> None:
    """Make ``nl_cuda`` build and launch ``text`` in place of ``csrc/nl_kernels.cu``."""
    from neurallaplacecontrol_tpu_torch.ops import nl_cuda

    path = os.path.join(tmp, f"nl_kernels_{abs(hash(text))}.cu")
    with open(path, "w") as f:
        f.write(text)
    nl_cuda.SOURCES = (Path(path),)
    nl_cuda.library.cache_clear()
    nl_cuda._READY.clear()
    nl_cuda.build(Path(tmp) / "build")


def head_errors(device, cfg) -> dict:
    """The head kernel against its plain version as ``chip_smoke.py`` phase
    ``kernels`` checks it: each env's tracked d1 checkpoint, B = 1,000, the
    same seeded hidden states; ``rel_err`` per env."""
    out = {}
    terms, A = cfg.nl_s_recon_terms, cfg.action_buffer_size
    for i, env_name in enumerate(chip_smoke.ENVS):
        env, params, model = chip_smoke.load_nl(env_name, device)
        spec = env.spec
        head = model.make_fused_planner_apply(params, cfg.dt).packed[15:]
        rng = np.random.default_rng(3 + i)  # drawn in check_kernels's order: obs, actions, hidden
        rng.standard_normal((chip_smoke.K, spec.n_obs))
        rng.uniform(-spec.action_high, spec.action_high, (chip_smoke.K, A * spec.m))
        x = torch.tensor(np.tanh(rng.standard_normal((chip_smoke.K, head[0].shape[0]))), dtype=torch.float32,
                         device=device)
        hopper = torch.as_tensor(pallas_ilt.repack_head(head, spec.n_obs, terms), device=device)
        got = pallas_ilt.nl_head_fused(x, head, spec.n_obs, terms=terms, hopper=hopper)
        out[env_name] = chip_smoke.rel_err(got, pallas_ilt.nl_head_plain(x, head, spec.n_obs))
    return out


def kernel() -> None:
    from neurallaplacecontrol_tpu_torch.data import collect_expert_data
    from neurallaplacecontrol_tpu_torch.ops import nl_cuda
    from neurallaplacecontrol_tpu_torch.training import train_model
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    device = torch.device("cuda")  # raises without a GPU
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = port.Config()
    ref = chip_smoke.read_jax_train_reference()
    weights = {
        "jax_init": (ENV, from_jax_params(ref["init"], device=device)),
        "jax_250": (ENV, from_jax_params(ref["final"], device=device)),
    }
    for env_name in chip_smoke.ENVS:
        weights[f"tracked_{env_name}_d1"] = (env_name, load_pytree(
            resolve_checkpoint(model_checkpoint_name("nl", env_name, 1, "exp", 0, True)), device=device))
    with tempfile.TemporaryDirectory() as tmp:
        collect_expert_data(ENV, 1, cfg.replace(offline_datasets_path=tmp), collect_samples=4000, device=device)
        tcfg = cfg.replace(offline_datasets_path=tmp, saved_models_path=tmp + "/saved/", training_epochs=4,
                           end_training_after_seconds=None)
        weights["port_trained"] = (ENV, train_model("nl", ENV, tcfg, delay=1, retrain=True, force_retrain=True,
                                                    device=device)[1])
    source = nl_cuda.SOURCES[0].read_text()
    with tempfile.TemporaryDirectory() as tmp:
        for fault, edits in FAULTS.items():
            text = source
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"fault {fault}: {old!r} is not in the source")
                text = text.replace(old, new)
            use_kernel_source(text, tmp)
            print(json.dumps({"mode": "head", "fault": fault, "device": torch.cuda.get_device_name(0),
                              "rel_err": head_errors(device, cfg)}), flush=True)
            for name, (env_name, params) in weights.items():
                spec = make_env(env_name).spec
                model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, cfg, device=device)
                fused = model.make_fused_planner_apply(params, cfg.dt)
                for rows in ROWS:
                    rng = np.random.default_rng(rows)
                    obs = torch.tensor(rng.standard_normal((rows, spec.n_obs)), dtype=torch.float32, device=device)
                    acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high,
                                                    (rows, cfg.action_buffer_size * spec.m)),
                                        dtype=torch.float32, device=device)
                    got = pallas_nl.nl_forward_fused(obs, acts, fused.packed, spec.n_obs, spec.m,
                                                     terms=cfg.nl_s_recon_terms, hopper=fused.hopper)
                    print(json.dumps({"mode": "kernel", "fault": fault, "weights": name, "rows": rows,
                                      "device": torch.cuda.get_device_name(0),
                                      **chip_smoke.forward_errors(got, obs, acts, fused.packed, spec.n_obs,
                                                                  spec.m)}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


def timing(old_source: str) -> None:
    from neurallaplacecontrol_tpu_torch.ops import nl_cuda

    device = torch.device("cuda")  # raises without a GPU
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = port.Config()
    env, params, model = chip_smoke.load_nl(chip_smoke.MAIN_ENV, device)
    spec = env.spec
    fused = model.make_fused_planner_apply(params, cfg.dt)
    inputs = {}
    for rows in ROWS:
        rng = np.random.default_rng(rows)
        obs = torch.tensor(rng.standard_normal((rows, spec.n_obs)), dtype=torch.float32, device=device)
        acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high, (rows, cfg.action_buffer_size * spec.m)),
                            dtype=torch.float32, device=device)
        inputs[rows] = (obs, acts, pallas_nl.nl_forward_plain(obs, acts, fused.packed, spec.n_obs, spec.m))
    sources = {"old": Path(old_source).read_text(), "new": nl_cuda.SOURCES[0].read_text()}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, which in enumerate(("old", "new", "new", "old")):
            use_kernel_source(sources[which], tmp)
            for rows, (obs, acts, exp) in inputs.items():
                def run():
                    return pallas_nl.nl_forward_fused(obs, acts, fused.packed, spec.n_obs, spec.m,
                                                      terms=cfg.nl_s_recon_terms, hopper=fused.hopper)

                got = run()
                print(json.dumps({"mode": "timing", "turn": turn, "source": which, "rows": rows,
                                  "ms": chip_smoke.graph_ms(run, 20), "rel_err": chip_smoke.rel_err(got, exp),
                                  "device": torch.cuda.get_device_name(0)}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    modes = {"gaps": gaps, "kernel": kernel, "timing": timing}
    if len(sys.argv) not in (2, 3) or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} {{{'|'.join(modes)}}} [device]")
    modes[sys.argv[1]](*sys.argv[2:])
