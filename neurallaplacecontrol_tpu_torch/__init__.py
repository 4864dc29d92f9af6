"""neurallaplacecontrol_tpu_torch — the PyTorch/CUDA port of neurallaplacecontrol_tpu.

The port runs the Neural Laplace Control stack on an NVIDIA H100. It mirrors
the JAX package's module layout and names, so every module here has its
counterpart at the same relative path under ``neurallaplacecontrol_tpu/``,
which stays the reference the port is tested against. The port imports
``torch`` and numpy only; it never imports ``jax`` or the JAX package.

The port covers the NL flagship end to end: checkpoints, the NL model
under all six ILT algorithms, the environments and their oracles, the
delay-aware MPPI planner with the serving controller
(``serving.make_controller``, exported with ``serving.export_controller``),
seed-batched evaluation
(``training.evaluate_policy``), expert and synthetic data (``data``) and
training (``training.train_model``). The planner-path NL forward is a
hand-written CUDA kernel (``ops.pallas_nl``; ``ops.pallas_ilt`` holds its
head-only sibling). Off the paper's path it has the ODE-RL stack
(``oderl``), the sequence baselines (``models.seq_baselines``) with the toy
data (``data.toy``), and the two-frame latent data.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; pass ``device="cpu"`` to run on the CPU, where every kernel wrapper
computes its plain PyTorch version instead.
"""

__version__ = "0.1.0"

# the entry points, imported at first use: loading an exported controller
# (``serving.load_controller_step``) imports the operators and no model code
_EXPORTS = {
    "Config": ".config",
    "make_env": ".envs",
    "make_model": ".models",
    "Controller": ".serving",
    "ControllerState": ".serving",
    "make_controller": ".serving",
    "evaluate_policy": ".training",
    "train_model": ".training",
}
__all__ = sorted(_EXPORTS)
# sub-packages reached as attributes, imported at first use (the JAX package's _LAZY)
_LAZY = {"oderl", "results", "serving", "tune"}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        return importlib.import_module(f".{name}", __name__)
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    globals()[name] = value
    return value
