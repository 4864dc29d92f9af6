"""The port stands alone: nothing reachable from neurallaplacecontrol_tpu_torch,
chip_smoke.py or run_exp_multi_torch.py imports JAX or the JAX package, entry points never drop to
the CPU on their own, and the port's sources keep the repo's hygiene rules."""

import ast
import io
import os
import subprocess
import sys
import textwrap
import tokenize
from pathlib import Path

import pytest
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.data import (
    SyntheticDraws,
    collect_expert_data,
    get_val_loss_delay_time_multi,
    load_replay_buffer,
    save_replay_buffer,
)
from neurallaplacecontrol_tpu_torch.parallel import multihost
from neurallaplacecontrol_tpu_torch.training import (
    SeedDraws,
    evaluate_policy,
    run_mppi_sweep,
    train_model,
    train_model_ensemble,
)
from neurallaplacecontrol_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import run_exp_multi_torch  # noqa: E402
PORT_FILES = sorted((REPO / "neurallaplacecontrol_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "run_exp_multi_torch.py", REPO / "scripts" / "port_shard_check.py",
    REPO / "scripts" / "serve_demo_torch.py", REPO / "scripts" / "port_deploy_check.py",
    REPO / "scripts" / "port_precision_check.py", REPO / "scripts" / "bench_bf16_torch.py",
    REPO / "scripts" / "bench_int8_torch.py", REPO / "scripts" / "oderl_demo_torch.py",
    REPO / "scripts" / "bench_episode_batch_torch.py", REPO / "scripts" / "bench_scaling_torch.py",
    REPO / "scripts" / "bench_train_torch.py", REPO / "scripts" / "bench_pallas_torch.py",
    REPO / "scripts" / "bench_mxu_sweep_torch.py", REPO / "scripts" / "port_research_check.py",
    REPO / "bench_torch.py", REPO / "scripts" / "e2e_nl_pendulum_torch.py", REPO / "scripts" / "eval_bigk_torch.py",
    REPO / "scripts" / "heldout_parity_torch.py", REPO / "scripts" / "env_simulator_torch.py",
    REPO / "scripts" / "make_readme_table_torch.py", REPO / "scripts" / "calibrate_cme_torch.py",
    REPO / "scripts" / "port_families_table.py"]
FORBIDDEN = ("jax", "neurallaplacecontrol_tpu")


def forbidden(module: str) -> bool:
    """Exact-name match: ``jax``, ``neurallaplacecontrol_tpu`` and their
    submodules, but not ``neurallaplacecontrol_tpu_torch``."""
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def test_forbidden_matches_exact_names_only():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("neurallaplacecontrol_tpu") and forbidden("neurallaplacecontrol_tpu.ops.ilt")
    assert not forbidden("neurallaplacecontrol_tpu_torch")
    assert not forbidden("neurallaplacecontrol_tpu_torch.ops") and not forbidden("jaxtyping")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        assert not any(forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_port_and_chip_smoke_import_and_tick_without_jax():
    """With jax and the JAX package blocked from import, the port and
    chip_smoke (module only) import, and a CPU controller ticks."""
    code = textwrap.dedent(
        """
        import json
        import sys
        sys.modules["jax"] = None
        sys.modules["neurallaplacecontrol_tpu"] = None
        import torch
        import neurallaplacecontrol_tpu_torch as port
        import chip_smoke
        from neurallaplacecontrol_tpu_torch.utils.checkpoint import (
            load_pytree, model_checkpoint_name, resolve_checkpoint)

        env = "oderl-cartpole"
        params = load_pytree(resolve_checkpoint(
            model_checkpoint_name("nl", env, 1, "exp", 0, True)), device="cpu")
        cfg = port.Config(fused_nl_planner=True)
        model = port.make_model("nl", env, 5, 1, 3.0, cfg, device="cpu")
        ctrl = port.make_controller("nl", env, 1, cfg, model_apply=model.apply, params=params,
                                    roll_outs=16, time_steps=4, device="cpu")
        action, state = ctrl.step(ctrl.reset(0), torch.zeros(5))
        assert action.shape == (1,) and bool(torch.isfinite(action).all())
        from neurallaplacecontrol_tpu_torch.training import evaluate_policy
        r = evaluate_policy("nl", env, 1, [0, 1], cfg.replace(dt=2.5), model_apply=model.apply,
                            params=params, roll_outs=8, time_steps=2, device="cpu")
        assert len(r["total_rewards"]) == 2
        # the training slice: the JAX run's artifact through chip_smoke's
        # reader, a few port updates on it, synthetic data, validation, all ILTs
        from neurallaplacecontrol_tpu_torch.data import SyntheticDraws, get_val_loss_delay_time_multi
        from neurallaplacecontrol_tpu_torch.ops import inverse_laplace
        from neurallaplacecontrol_tpu_torch.training import make_optimizer, make_train_segment_fn, train_model
        from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params
        ref = chip_smoke.read_jax_train_reference()
        assert ref["losses"].shape == ref["losses64"].shape == (1, 250) and ref["meta"]["env"] == "oderl-pendulum"
        pmodel = port.make_model("nl", "oderl-pendulum", 3, 1, 2.0, port.Config(), device="cpu")
        p0 = from_jax_params(ref["init"], device="cpu")
        opt = make_optimizer(port.Config())
        data = [torch.as_tensor(ref["data"][k]) for k in ("s0", "a0", "sn", "ts")]
        idx = torch.as_tensor(ref["batch_idx"][0][:3], dtype=torch.long)
        _, state, losses = make_train_segment_fn(pmodel, opt)(p0, opt.init(p0), *data, idx)
        assert int(state.count) == 3 and bool(torch.isfinite(losses).all())
        env_p = port.make_env("oderl-pendulum")
        val = get_val_loss_delay_time_multi(pmodel.apply, p0, env_p, 1, samples_per_dim=2, device="cpu")
        assert val > 0
        for alg in ("fourier", "dehoog", "stehfest", "fixed_talbot", "euler", "cme"):
            f = inverse_laplace(lambda s: 1.0 / (s + 1.0), torch.tensor([0.5, 1.0]), 17, alg)
            assert bool(torch.isfinite(f).all()), alg
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            tcfg = port.Config(train_with_expert_trajectories=False, train_samples_per_dim=2,
                               nl_hidden_units=16, training_epochs=1, saved_models_path=tmp + "/",
                               end_training_after_seconds=None)
            _, _, res = train_model("nl", "oderl-pendulum", tcfg, delay=1, retrain=True,
                                    force_retrain=True, device="cpu")
            assert len(res["epoch_losses"]) == 1
        # the baseline families: the reference's forwards through chip_smoke's
        # reader, a carried latent-ODE tick, and a latent-ODE training segment
        bref = chip_smoke.read_jax_baselines_reference()
        assert bref["meta"]["env"] == "oderl-pendulum" and bref["inputs/obs"].shape == (1000, 3)
        assert set(bref["jax_returns"]) >= {"rnn", "delta_t_rnn", "node", "latent_ode", "oracle", "random"}
        q = [torch.as_tensor(bref[f"inputs/{k}"][:64]) for k in ("obs", "abuf", "ts")]
        for fam in ("rnn", "delta_t_rnn", "node", "latent_ode"):
            fmodel, fparams = chip_smoke.load_family(fam, torch.device("cpu"), z0_noise=bref["latent_ode/z0"][:64])
            got = fmodel.apply(fparams, *q)
            assert float(((got.double() - torch.as_tensor(bref[f"out/{fam}"][:64])).abs()).max()) < 1e-3, fam
        lode, lparams = chip_smoke.load_family("latent_ode", torch.device("cpu"))
        lctrl = port.make_controller("latent_ode", "oderl-pendulum", 1, port.Config(), model_apply=lode,
                                     params=lparams, roll_outs=8, time_steps=2, device="cpu")
        action, _ = lctrl.step(lctrl.reset(0), torch.zeros(3))
        assert action.shape == (1,) and bool(torch.isfinite(action).all())
        from neurallaplacecontrol_tpu_torch.training.train_latent_ode import (
            build_history_windows, make_latent_ode_segment_fn)
        windows = build_history_windows(*data, 4)
        eps = torch.as_tensor(bref["train/latent_ode/eps"][:2], dtype=torch.float32)
        _, lstate, llosses = make_latent_ode_segment_fn(lode, opt)(
            lparams, opt.init(lparams), eps, *windows,
            torch.as_tensor(bref["train/latent_ode/batch_idx"][:2], dtype=torch.long))
        assert int(lstate.count) == 2 and bool(torch.isfinite(llosses).all())
        # the orchestration slice: the driver's grid on the CPU, the results
        # tools, the ensemble, the sweep and the process helpers; the GPU
        # machine has no matplotlib, and none of these imports it
        import run_exp_multi_torch
        from neurallaplacecontrol_tpu_torch.parallel import multihost
        from neurallaplacecontrol_tpu_torch.results import summarize
        from neurallaplacecontrol_tpu_torch.training import SweepSpec, run_mppi_sweep, train_model_ensemble
        with tempfile.TemporaryDirectory() as tmp:
            out = run_exp_multi_torch.main([
                "--envs", "oderl-pendulum", "--delays", "0", "--models", "oracle,random", "--device", "cpu",
                "--results", tmp + "/r.jsonl", "--seed_runs", "2", "--dt", "2.5", "--mppi_roll_outs", "8",
                "--mppi_time_steps", "2", "--log_folder", tmp])
            assert len(out["records"]) == 2 and not any(r["errored"] for r in out["records"])
            summarize.main([tmp + "/r.jsonl"])
            best = run_mppi_sweep("oracle", "oderl-pendulum", 0, port.Config(dt=2.5),
                                  SweepSpec(roll_outs=(8,), time_steps=(2,), n_trials=2, base_seeds=1,
                                            max_seeds=1), device="cpu")
            assert len(best["trials"]) == 2
            ens = train_model_ensemble("rnn", "oderl-pendulum", tcfg.replace(rnn_hidden_units=8, saved_models_path=tmp + "/"),
                                       delays=[0, 1],
                                       force_retrain=True, device="cpu")
            assert set(ens) == {0, 1}
        assert multihost.process_slice([1, 2, 3], 1, 2) == [2]
        # the multi-device slice: meshes, the K-sharded planner, the grid and
        # the shard modes of a world of one, the dp x tp step, and the
        # chip's rank script
        import scripts.port_shard_check
        from neurallaplacecontrol_tpu_torch.parallel import (
            global_mesh, make_k_sharded_mppi_command, make_mesh, make_sharded_train_step, shard_params)
        mesh = make_mesh(device="cpu")
        assert global_mesh(device="cpu").devices.shape == (1,) and mesh.devices.shape == (1, 1)
        for kw in ({"shard_seeds": True}, {"shard_rollouts": True}, {"shard_grid": (1, 1)}):
            r = evaluate_policy("oracle", "oderl-pendulum", 1, [0, 1], port.Config(dt=2.5), roll_outs=8,
                                time_steps=2, device="cpu", **kw)
            assert r["shard_group_size"] == 1
        step = make_sharded_train_step(pmodel.apply, opt, mesh)
        p1, _, loss = step(shard_params(p0, mesh), opt.init(p0), *[x[:8] for x in data])
        assert bool(torch.isfinite(loss))
        # phase table's references: the JAX package's NL runs at HEAD, its records
        for env in chip_smoke.ENVS:
            for delay in chip_smoke.TABLE_DELAYS:
                age = (env, delay) == chip_smoke.AGE_CHANNEL_CELL
                assert chip_smoke.jax_cell_returns(env, delay, "nl", encode_obs_time=age).shape == (20,)
                assert chip_smoke.jax_cell_returns(env, delay, "oracle").shape == (20,)
        # phase precision: the reference .pt through interop into latent_ode_ref,
        # the bf16 and int8 routes, the JAX references of their batches
        from neurallaplacecontrol_tpu_torch import interop
        from neurallaplacecontrol_tpu_torch.ops import quant
        sd = interop.load_torch_state_dict(str(chip_smoke.REF_LATENT_ODE_PT))
        lor = port.make_model("latent_ode_ref", "oderl-cartpole", 5, 1, 3.0, device="cpu")
        out = lor.apply(interop.latent_ode_params_from_state_dict(sd, device="cpu", dtype=torch.float32),
                        torch.zeros(4, 5), torch.zeros(4, 4, 1), torch.full((4, 1), 0.05))
        assert out.shape == (4, 5) and bool(torch.isfinite(out).all())
        _, nl_params, _ = chip_smoke.load_nl("oderl-cartpole", torch.device("cpu"))
        spec = port.make_env("oderl-cartpole").spec
        qa = quant.quantized_apply_for("nl", "oderl-cartpole", nl_params, port.Config(), spec, fold_t=0.05)
        bf = port.make_model("nl", "oderl-cartpole", 5, 1, 3.0, port.Config(nl_compute_dtype="bfloat16"),
                             device="cpu")
        for f in (qa, bf.apply):
            assert bool(torch.isfinite(f(nl_params, torch.zeros(4, 5), torch.zeros(4, 4, 1),
                                         torch.full((4, 1), 0.05))).all())
        pref = json.loads(chip_smoke.JAX_PRECISION_REFERENCE.read_text())
        assert (pref["env"], pref["delay"], pref["seeds"]) == (chip_smoke.MAIN_ENV, chip_smoke.DELAY,
                                                                chip_smoke.EVAL_SEEDS)
        assert all(len(pref["policies"][k]["total_rewards"]) == 20 for k in ("bf16", "int8"))
        # phase research: the JAX run's artifact, the latent data part on the CPU,
        # the ODE-RL stack and the sequence models
        rref = chip_smoke.read_jax_research_reference()
        assert rref["gm/losses"].shape == rref["dyn/losses"].shape == rref["pol/rewards"].shape == (20,)
        lat = chip_smoke.research_latent(torch.device("cpu"), rref)
        assert max(lat["generator_rel_err"], lat["oracle_rel_err"]) < chip_smoke.RESEARCH_LATENT_TOL
        from neurallaplacecontrol_tpu_torch import oderl
        from neurallaplacecontrol_tpu_torch.models import seq_baselines
        octrl = oderl.make_ctrl(port.make_env("oderl-pendulum"), "enode", device="cpu")
        oparams = oderl.ctrl_params_from_jax(octrl, chip_smoke._tree(rref, "enode/init", "cpu"))
        st, rt, _ = octrl.forward_simulate(oparams, torch.Generator().manual_seed(0), 0.1,
                                           torch.as_tensor(rref["sim/s0"][:2], dtype=torch.float32))
        assert st.shape == (10, 2, 2, 3) and bool(torch.isfinite(st).all())
        smodel = seq_baselines.make_ode_rnn(1, device="cpu")
        sp = seq_baselines.sequence_params_from_jax(smodel, chip_smoke._tree(rref, "seq/ode_rnn/init", "cpu"))
        assert smodel.encode(sp, torch.as_tensor(rref["seq/x"]), torch.as_tensor(rref["seq/ts"])).shape == (6, 10)
        import scripts.oderl_demo_torch  # noqa: F401
        # the repo's own entry points (chip_smoke imports the others)
        import bench_torch
        import scripts.calibrate_cme_torch  # noqa: F401
        import scripts.env_simulator_torch  # noqa: F401
        assert bench_torch.nl_forward_flops_analytic(5, 1) == 384338
        assert "matplotlib" not in sys.modules
        loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                        or m == "neurallaplacecontrol_tpu"
                        or m.startswith("neurallaplacecontrol_tpu."))
        assert all(sys.modules[m] is None for m in loaded), loaded
        print("OK", chip_smoke.MAIN_ENV)
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK oderl-cartpole" in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Entry points default to device='cuda' and raise rather than drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_model("nl", "oderl-cartpole", 5, 1, 3.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_controller("nl", "oderl-cartpole", 1, model_apply=lambda *a: None, params={})
    name = checkpoint.model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load_pytree(checkpoint.resolve_checkpoint(name))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_policy("oracle", "oderl-cartpole", 1, [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeedDraws([0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collect_expert_data("oderl-pendulum", 1, port.Config(offline_datasets_path=str(tmp_path)))
    path = tmp_path / "buf.npz"
    save_replay_buffer(path, *(torch.zeros(2, 1) for _ in range(4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_replay_buffer(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model("nl", "oderl-pendulum", port.Config(saved_models_path=str(tmp_path) + "/"), retrain=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticDraws(0)
    env = port.make_env("oderl-pendulum")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_val_loss_delay_time_multi(lambda *a: None, None, env, 1)
    for family in ("rnn", "delta_t_rnn", "node", "latent_ode"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.make_model(family, "oderl-pendulum", 3, 1, 2.0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.make_controller(family, "oderl-pendulum", 1, model_apply=lambda *a: None, params={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_controller("oracle", "oderl-pendulum", 1)
    cfg = port.Config(saved_models_path=str(tmp_path) + "/")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model_ensemble("rnn", "oderl-pendulum", cfg, delays=[0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mppi_sweep("oracle", "oderl-pendulum", 0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize("127.0.0.1:1", 2, 0)
    from neurallaplacecontrol_tpu_torch.parallel import global_mesh, make_mesh

    for make in (make_mesh, global_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_policy("oracle", "oderl-cartpole", 1, [0], shard_rollouts=True)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_exp_multi_torch.main(["--envs", "oderl-pendulum", "--delays", "0", "--models", "oracle",
                                  "--results", str(tmp_path / "r.jsonl"), "--log_folder", str(tmp_path / "logs")])
    assert not (tmp_path / "r.jsonl").exists() and not (tmp_path / "logs").exists()
    import bench_torch
    from scripts import e2e_nl_pendulum_torch, eval_bigk_torch, heldout_parity_torch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main()
    for main in (eval_bigk_torch.main, heldout_parity_torch.main, e2e_nl_pendulum_torch.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--out", str(tmp_path / "entry.out")])
    assert not (tmp_path / "entry.out").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_hygiene(path):
    """The rules tests/test_lint.py applies to the JAX package."""
    text = path.read_text()
    ast.parse(text, filename=str(path))
    list(tokenize.generate_tokens(io.StringIO(text).readline))
    for i, line in enumerate(text.splitlines(), 1):
        assert line == line.rstrip(), f"{path}:{i}: trailing whitespace"
        assert "\t" not in line, f"{path}:{i}: tab character"
    assert text.endswith("\n") and not text.endswith("\n\n"), f"{path}: final newline"
    assert "breakpoint(" not in text and "import pdb" not in text


@pytest.mark.parametrize("args", [[], ["--phase", "widths"]], ids=["whole", "one_phase"])
def test_chip_smoke_fails_without_cuda(args):
    """chip_smoke.py, whole or one phase, exits non-zero and prints no result
    line where torch sees no CUDA device."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr and '"ok"' not in run.stdout
