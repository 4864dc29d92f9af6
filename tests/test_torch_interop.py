"""The port's ``interop`` (reference ``.pt`` state dicts to parameter trees and
back) against the JAX package's, for every family: exports of one tree of
numpy-seeded values are equal key for key and bit for bit, imports of one
state dict give equal leaves, a round trip reproduces every tensor, and the
tracked reference checkpoint reads the same through both loaders."""

from pathlib import Path

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu import interop as jinterop
from neurallaplacecontrol_tpu_torch import interop as tinterop
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
REF_PT = REPO / "artifacts" / "baseline_parity" / "ref_latent_ode_cartpole_d1_r4.pt"
ENV, N, M, HIGH, DT = "oderl-cartpole", 5, 1, 3.0, 0.05

# case -> (model name, config, the interop functions' prefix)
FAMILIES = {
    "nl": ("nl", TConfig(), "nl"),
    "nl_age": ("nl", TConfig(encode_obs_time=True), "nl"),
    "rnn": ("rnn", TConfig(), "rnn"),
    "delta_t_rnn": ("delta_t_rnn", TConfig(), "rnn"),
    "node": ("node", TConfig(), "node"),
    "latent_ode_ref": ("latent_ode_ref", TConfig(), "latent_ode"),
}


def seeded_tree(family, seed=0):
    """A parameter tree of the family's shapes holding numpy-seeded f64 values."""
    model_name, cfg, _ = FAMILIES[family]
    like = torch_make_model(model_name, ENV, N, M, HIGH, cfg, dtype=torch.float64, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.tensor(rng.standard_normal(tuple(x.shape))), like)


def reference_sd(family, seed):
    """A reference-format state dict (torch tensors) of numpy-seeded values:
    the JAX package's export, or for node, which it does not export, the
    reference NODE's keys (train_utils.py:637-662) written out here."""
    tree = tree_map(lambda x: x.numpy(), seeded_tree(family, seed))
    if family == "node":
        prefix = "x_ode_func_in_x_and_u.linear_tanh_stack"
        sd = {}
        for slot, p in zip((0, 2, 4), tree["ode_func"]):
            sd[f"{prefix}.{slot}.weight"], sd[f"{prefix}.{slot}.bias"] = p["w"].T, p["b"]
    else:
        sd = mapping(jinterop, family, "export")(tree)
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def mapping(module, family, direction):
    prefix = FAMILIES[family][2]
    return getattr(module, f"{prefix}_state_dict_from_params" if direction == "export"
                   else f"{prefix}_params_from_state_dict")


def jax_leaves(tree):
    """The JAX tree's leaves in the port's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in jax_leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"node"}))
@pytest.mark.parametrize("buffers", [False, True], ids=["weights", "buffers"])
def test_export_matches_jax(family, buffers):
    """One tree exported by both packages: the same keys, each array equal
    in value, dtype and shape (the buffers when ``norm``/``dt`` are given).
    node has an import only, in both packages."""
    tree = seeded_tree(family)
    jtree = tree_map(lambda x: x.numpy(), tree)
    kw = dict(norm=norm_stats_for(ENV, HIGH, M), dt=DT) if buffers else {}
    got = mapping(tinterop, family, "export")(tree, **kw)
    exp = mapping(jinterop, family, "export")(jtree, **kw)
    assert set(got) == set(exp)
    for k, v in exp.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_matches_jax(family):
    """One reference state dict (torch tensor values) imported by both
    packages: equal leaves, in the state dict's dtype, or cast by ``dtype``;
    the port's export of its import reproduces the state dict bit for bit."""
    sd = reference_sd(family, 1)
    exp = jax_leaves(mapping(jinterop, family, "import")(sd))
    got = tree_leaves(mapping(tinterop, family, "import")(sd, device="cpu"))
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == torch.float64 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), e)
    f32 = tree_leaves(mapping(tinterop, family, "import")(sd, device="cpu", dtype=torch.float32))
    assert all(x.dtype == torch.float32 for x in f32)
    if family == "node":
        return
    back = mapping(tinterop, family, "export")(mapping(tinterop, family, "import")(sd, device="cpu"))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_import_refuses_cuda_without_a_card():
    """Imports default to the card, as every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinterop.latent_ode_params_from_state_dict(tinterop.load_torch_state_dict(str(REF_PT)))


def test_tracked_reference_pt_through_both_loaders():
    """The tracked reference checkpoint (35 f64 tensors): both loaders read
    the same arrays, both arch readers agree, and the port's import exports
    back to the file bit for bit, its buffers included."""
    jsd = jinterop.load_torch_state_dict(str(REF_PT))
    tsd = tinterop.load_torch_state_dict(str(REF_PT))
    assert set(tsd) == set(jsd) and len(tsd) == 35
    for k, v in jsd.items():
        assert tsd[k].dtype == v.dtype == np.float64
        np.testing.assert_array_equal(tsd[k], v, err_msg=k)
    arch = tinterop.latent_ode_arch_from_state_dict(tsd)
    assert arch == jinterop.latent_ode_arch_from_state_dict(jsd)
    assert arch == {"state_dim": 5, "action_dim": 1, "hidden_units": 128, "rec_dims": 20}
    back = tinterop.latent_ode_state_dict_from_params(
        tinterop.latent_ode_params_from_state_dict(tsd, device="cpu"),
        norm=norm_stats_for(ENV, HIGH, M), dt=float(tsd["dt"]))
    raw = torch.load(REF_PT, weights_only=True)
    assert set(back) == set(raw)
    for k, v in raw.items():
        assert back[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_load_unwraps_model_state_dict(tmp_path):
    """A ``{"model_state_dict": ...}`` wrapper is unwrapped by both loaders."""
    sd = reference_sd("rnn", 2)
    path = tmp_path / "wrapped.pt"
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    got, exp = tinterop.load_torch_state_dict(str(path)), jinterop.load_torch_state_dict(str(path))
    assert set(got) == set(exp) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], exp[k])


@pytest.mark.parametrize("algorithm,terms", [("fourier", 17), ("fourier", 33), ("cme", 17), ("cme", 33)])
@pytest.mark.parametrize("hidden", [64, 128])
def test_nl_arch_from_state_dict_matches_jax(algorithm, terms, hidden):
    """The constructor arguments read off an NL state dict, the CME head's
    snapped count stepped back to the request as in the JAX package; the
    model built from them takes the weights."""
    cfg = TConfig(nl_ilt_algorithm=algorithm, nl_s_recon_terms=terms, nl_hidden_units=hidden)
    model = torch_make_model("nl", ENV, N, M, HIGH, cfg, dtype=torch.float64, device="cpu")
    sd = tinterop.nl_state_dict_from_params(model.init(torch.Generator().manual_seed(0)))
    got = tinterop.nl_arch_from_state_dict(sd, N, algorithm)
    assert got == jinterop.nl_arch_from_state_dict(sd, N, algorithm)
    assert got["hidden_units"] == hidden and got["gru_in"] == M
    again = torch_make_model("nl", ENV, N, M, HIGH, cfg.replace(nl_s_recon_terms=got["s_recon_terms"]),
                             dtype=torch.float64, device="cpu")
    shapes = [tuple(x.shape) for x in tree_leaves(again.init(torch.Generator().manual_seed(0)))]
    assert shapes == [tuple(x.shape) for x in tree_leaves(tinterop.nl_params_from_state_dict(sd, device="cpu"))]


def test_import_names_the_missing_weight():
    full = reference_sd("nl", 3)
    del full["laplace_rep_func.linear_tanh_stack.2.bias"]
    with pytest.raises(KeyError, match="linear_tanh_stack.2.bias"):
        tinterop.nl_params_from_state_dict(full, device="cpu")
