"""Trajectory and result plotting (port of ``results/plotting.py``).

Replaces the plotting surface of the reference (baseline_models/
latent_ode_lib/plotting.py trajectory plots; the normalized-return
constants of process_results/plot_util.py live in results.process).
Matplotlib is imported when a plot is drawn, with the Agg backend, so no
display is needed; nothing else in the package imports this module, and a
machine without matplotlib runs everything but the plots.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _numpy(x):
    """A numpy array of ``x``, a tensor on any device or an array-like."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_trajectories(ts, true_traj, pred_traj=None, dims: Optional[Sequence[int]] = None,
                      path: Optional[str] = None, title: str = ""):
    """Per-dimension true-vs-predicted trajectory panels
    (latent_ode_lib/plotting.py style). true/pred: [T, D] or [N, T, D]
    (first trajectory is drawn); tensors are read through numpy."""
    plt = _plt()
    true_traj = _numpy(true_traj)
    if true_traj.ndim == 3:
        true_traj = true_traj[0]
    if pred_traj is not None:
        pred_traj = _numpy(pred_traj)
        if pred_traj.ndim == 3:
            pred_traj = pred_traj[0]
    ts = _numpy(ts)
    dims = list(dims) if dims is not None else list(range(true_traj.shape[-1]))
    fig, axes = plt.subplots(len(dims), 1, figsize=(6, 2 * len(dims)), squeeze=False)
    for ax, d in zip(axes[:, 0], dims):
        ax.plot(ts, true_traj[:, d], "k-", lw=1.5, label="true")
        if pred_traj is not None:
            ax.plot(ts, pred_traj[:, d], "C0--", lw=1.5, label="pred")
        ax.set_ylabel(f"dim {d}")
    axes[0, 0].legend(loc="best")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig


# fixed categorical order (identity encoding: the hue follows the model,
# never its rank or panel) — a colorblind-validated 6-slot palette
_MODEL_COLORS = {
    "nl": "#2a78d6",  # blue: the flagship
    "oracle": "#eb6834",
    "random": "#eda100",
    "delta_t_rnn": "#1baf7a",
    "node": "#e87ba4",
    "latent_ode": "#008300",
    "rnn": "#6d6c64",  # overflow family folds to gray, not a generated hue
}


def plot_matrix_scores(records: Sequence[dict], path: Optional[str] = None,
                       models: Optional[Sequence[str]] = None):
    """The full-protocol headline as a figure: normalized score (100 =
    oracle, 0 = random, clipped at 0 — process.py's definition from
    reference process_logs.py:183-190) per model, one panel per env,
    grouped by action delay. Error bars are the per-seed std. The
    reference publishes this only as a LaTeX table.
    """
    plt = _plt()
    from .process import normalized_scores

    scores = normalized_scores(records)
    envs = sorted({e for (_, e, _) in scores})
    delays = sorted({d for (d, _, _) in scores})
    if models is None:
        present = {m for (_, _, m) in scores}
        models = [m for m in _MODEL_COLORS if m in present] + sorted(
            m for m in present if m not in _MODEL_COLORS
        )

    fig, axes = plt.subplots(
        1, max(len(envs), 1), figsize=(4.2 * max(len(envs), 1), 3.4),
        sharey=True, squeeze=False,
    )
    n_m = len(models)
    group_w = 0.84
    bar_w = group_w / n_m
    for ax, env in zip(axes[0], envs):
        for mi, model in enumerate(models):
            xs, ys, es = [], [], []
            for di, delay in enumerate(delays):
                if (delay, env, model) not in scores:
                    continue
                mean, std, _ = scores[(delay, env, model)]
                xs.append(di - group_w / 2 + (mi + 0.5) * bar_w)
                ys.append(mean)
                es.append(std)
            if not xs:
                continue
            ax.bar(
                xs, ys, width=bar_w * 0.86,  # the gap between fills
                color=_MODEL_COLORS.get(model, "#6d6c64"),
                yerr=es, error_kw=dict(elinewidth=0.8, ecolor="#6d6c64", capsize=1.5),
                label=model,
            )
        ax.set_title(env.replace("oderl-", ""), fontsize=11)
        ax.set_xticks(range(len(delays)), [f"d={d}" for d in delays], fontsize=9)
        ax.axhline(100.0, color="#c3c2b7", lw=0.8, ls="--", zorder=0)
        ax.spines[["top", "right"]].set_visible(False)
        ax.grid(axis="y", color="#eceae3", lw=0.6, zorder=0)
        ax.set_axisbelow(True)
    axes[0][0].set_ylabel("normalized score (oracle=100, random=0)", fontsize=9)
    handles, labels = axes[0][0].get_legend_handles_labels()
    fig.legend(
        handles, labels, loc="upper center", ncol=len(models),
        fontsize=8, frameon=False, bbox_to_anchor=(0.5, 1.02),
    )
    fig.tight_layout(rect=(0, 0, 1, 0.93))
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_episode_returns(records: Sequence[dict], path: Optional[str] = None):
    """Bar chart of mean episode return per (model, delay) from result
    records (the table of results.process as a figure)."""
    plt = _plt()
    by = {}
    for r in records:
        if r.get("errored"):
            continue
        by.setdefault((r["model_name"], r["delay"]), []).append(r["total_reward"])
    labels = [f"{m}\nd={d}" for (m, d) in by]
    means = [float(np.mean(v)) for v in by.values()]
    stds = [float(np.std(v)) for v in by.values()]
    fig, ax = plt.subplots(figsize=(max(6, len(labels)), 3.2))
    ax.bar(range(len(labels)), means, yerr=stds, color="#6080c0")
    ax.set_xticks(range(len(labels)), labels, fontsize=8)
    ax.set_ylabel("episode return")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig
