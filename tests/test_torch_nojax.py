"""The port stands alone: nothing reachable from neurallaplacecontrol_tpu_torch
or chip_smoke.py imports JAX or the JAX package, entry points never drop to
the CPU on their own, and the port's sources keep the repo's hygiene rules."""

import ast
import io
import subprocess
import sys
import textwrap
import tokenize
from pathlib import Path

import pytest
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "neurallaplacecontrol_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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


def test_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to device='cuda' and raise rather than drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_model("nl", "oderl-cartpole", 5, 1, 3.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.make_controller("nl", "oderl-cartpole", 1, model_apply=lambda *a: None, params={})
    name = checkpoint.model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load_pytree(checkpoint.resolve_checkpoint(name))


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
