"""Probe of the JAX package's latent-ODE ensemble segment on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_jax_ensemble_probe.py [--updates 20]

Runs ``training/ensemble.py::_make_latent_ode_segment_fn`` at f64 (narrow:
32 units, 5 latents; two members on seeded history windows of their own,
batch 4, each member on its own key) three ways and prints one JSON line
with the largest relative gap of one update's loss between them:

- ``jit_two_members``: the segment as the package runs it, jitted over both
  members at once;
- ``one_member_each``: the same jitted segment over each member alone;
- ``eager_two_members``: both members at once under ``jax.disable_jit()``.

Members do not interact, so all three should agree. The port's test
``tests/test_torch_ensemble.py::test_latent_ode_ensemble_segment_matches_jax_f64``
holds the port to ``one_member_each``. The eager run takes ~28 s per update.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurallaplacecontrol_tpu.config import Config  # noqa: E402
from neurallaplacecontrol_tpu.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu.training import ensemble, train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=20)
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    cfg = Config(latent_ode_hidden_units=32)
    model = make_model("latent_ode", "oderl-pendulum", 3, 1, 2.0, cfg, dtype=jnp.float64)
    params = ensemble._stack_trees([model.init(jax.random.PRNGKey(k)) for k in (6, 7)])
    rng = np.random.default_rng(0)
    data = [jnp.asarray(x) for x in (rng.standard_normal((2, 20, 4, 3)), rng.standard_normal((2, 20, 4, 1)),
                                     rng.standard_normal((2, 20, 3)), rng.exponential(0.05, (2, 20, 1)))]
    idx = jnp.asarray(np.random.default_rng(1).integers(0, 20, (args.updates, 4)))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(8), i) for i in range(2)])
    opt = train.make_optimizer(cfg)
    segment = ensemble._make_latent_ode_segment_fn(model.train_step, opt)

    def run(p, k, d):  # the segment donates its params: hand it a copy
        p = jax.tree_util.tree_map(jnp.copy, p)
        return np.asarray(segment(p, jax.vmap(opt.init)(p), k, *d, idx)[2])

    def member(i):
        return jax.tree_util.tree_map(lambda x: x[i:i + 1], params)

    t0 = time.perf_counter()
    jit_two = run(params, keys, data)
    one_each = np.concatenate([run(member(i), keys[i:i + 1], [x[i:i + 1] for x in data]) for i in range(2)])
    t1 = time.perf_counter()
    with jax.disable_jit():
        eager_two = run(params, keys, data)
    t2 = time.perf_counter()

    def gap(a, b):
        return float(np.max(np.abs(a / b - 1.0)))

    print(json.dumps({"updates": args.updates, "jax": jax.__version__,
                      "jit_two_members_vs_one_member_each": gap(jit_two, one_each),
                      "eager_two_members_vs_one_member_each": gap(eager_two, one_each),
                      "jit_two_members_vs_eager": gap(jit_two, eager_two),
                      "first_losses": {"jit_two_members": jit_two[:, 0].tolist(),
                                       "one_member_each": one_each[:, 0].tolist(),
                                       "eager_two_members": eager_two[:, 0].tolist()},
                      "seconds_jit": t1 - t0, "seconds_eager": t2 - t1}))


if __name__ == "__main__":
    main()
