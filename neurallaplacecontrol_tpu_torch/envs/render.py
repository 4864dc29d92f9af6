"""Host-side episode rendering and video export (port of ``envs/render.py``).

The reference renders through gym's OpenGL classic-control viewer and a
virtual X display (ctcartpole.py:348-409, ctpendulum.py:157-183,
ctacrobot.py:257-286) and writes videos with imageio
(mppi_with_model.py:282-285). Here, as in the JAX package, frames are
rasterized with matplotlib's Agg backend from the raw states of a recorded
episode (``training.rollout.EpisodeRecords``) after it has run, and the
drawing code is the JAX module's, so a frame is pixel-equal to its frame of
the same state.

matplotlib and imageio are imported at first use, not with the package:
the GPU machine has neither, and asking for video there raises
``ImportError`` (``require``).
"""

from __future__ import annotations

import numpy as np
import torch


def require() -> None:
    """Raise ``ImportError`` unless matplotlib and imageio import."""
    try:
        import imageio  # noqa: F401
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"episode video needs matplotlib and imageio, and this Python lacks them ({e}); "
                          "evaluate without save_video, or install them") from e


def _fig_to_rgb(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


def _new_fig(xlim, ylim, figsize=(3.04, 2.0), dpi=100):
    require()
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def render_cartpole(raw_state, last_act=None) -> np.ndarray:
    """One cartpole frame from raw state [x, x_dot, theta, theta_dot]
    (ctcartpole.render:348-409; theta=0 is upright)."""
    fig, ax = _new_fig((-4.5, 4.5), (-1.5, 1.5))
    import matplotlib.pyplot as plt

    x, theta = float(raw_state[0]), float(raw_state[2])
    ax.axhline(0.0, color="black", lw=0.8)  # track
    cart_w, cart_h = 0.75, 0.45
    ax.add_patch(plt.Rectangle((x - cart_w / 2, -cart_h / 2), cart_w, cart_h, color="#404040"))
    tip = (x + np.sin(theta), np.cos(theta))
    ax.plot([x, tip[0]], [cart_h / 5, cart_h / 5 + tip[1]], color="#cc9966", lw=4)
    ax.add_patch(plt.Circle((x, cart_h / 5), 0.07, color="#8080cc"))
    if last_act is not None:
        ax.arrow(x, -0.8, float(np.asarray(last_act).ravel()[0]) / 3.0, 0.0, head_width=0.12, color="#cc3333")
    rgb = _fig_to_rgb(fig)
    plt.close(fig)
    return rgb


def render_pendulum(raw_state, last_act=None) -> np.ndarray:
    """One pendulum frame from raw state [theta, theta_dot]
    (ctpendulum.render:157-183; theta=0 is upright)."""
    fig, ax = _new_fig((-1.4, 1.4), (-1.4, 1.4), figsize=(2.0, 2.0))
    import matplotlib.pyplot as plt

    theta = float(raw_state[0])
    tip = (np.sin(theta), np.cos(theta))
    ax.plot([0, tip[0]], [0, tip[1]], color="#cc9966", lw=5)
    ax.add_patch(plt.Circle((0, 0), 0.05, color="#8080cc"))
    if last_act is not None:
        ax.arrow(0.0, -1.2, float(np.asarray(last_act).ravel()[0]) / 2.0, 0.0, head_width=0.08, color="#cc3333")
    rgb = _fig_to_rgb(fig)
    plt.close(fig)
    return rgb


def render_acrobot(raw_state, last_act=None) -> np.ndarray:
    """One acrobot frame from raw state [theta1, theta2, dtheta1, dtheta2]
    (ctacrobot.render:257-286; theta1 measured from the downward vertical)."""
    fig, ax = _new_fig((-2.4, 2.4), (-2.4, 2.4), figsize=(2.0, 2.0))
    import matplotlib.pyplot as plt

    th1, th2 = float(raw_state[0]), float(raw_state[1])
    p1 = (np.sin(th1), -np.cos(th1))
    p2 = (p1[0] + np.sin(th1 + th2), p1[1] - np.cos(th1 + th2))
    ax.plot([0, p1[0]], [0, p1[1]], color="#cc9966", lw=5)
    ax.plot([p1[0], p2[0]], [p1[1], p2[1]], color="#66cc99", lw=5)
    for p in ((0, 0), p1):
        ax.add_patch(plt.Circle(p, 0.06, color="#8080cc"))
    rgb = _fig_to_rgb(fig)
    plt.close(fig)
    return rgb


_RENDERERS = {
    "cartpole": render_cartpole,
    "pendulum": render_pendulum,
    "acrobot": render_acrobot,
}


def render_frame(env_name: str, raw_state, last_act=None) -> np.ndarray:
    for k, fn in _RENDERERS.items():
        if k in env_name:
            return fn(np.asarray(raw_state), last_act=last_act)
    raise ValueError(f"No renderer for env {env_name}")


def render_episode(env, records, max_frames: int = 200, delay: int = 0) -> list:
    """RGB frames of one recorded episode (``EpisodeRecords`` without the
    seed axis). ``records.s0``'s trig observations go back to raw states
    through ``env.obs_to_state`` (base_env.obs2state:289-295); the force
    arrow shows the executed action, buffer slot -(delay+1)."""
    s0 = torch.as_tensor(records.s0)[:max_frames].detach().cpu()
    raws = env.obs_to_state(s0).numpy()
    acts = torch.as_tensor(records.a0)[:max_frames, -(delay + 1), : env.spec.m].detach().cpu().numpy()
    return [render_frame(env.spec.name, raws[i], last_act=acts[i]) for i in range(raws.shape[0])]


def save_video(frames, path: str, fps: int = 20) -> str:
    """Write frames to a video or gif file, chosen by the path's suffix
    (mppi_with_model.py:282-285); an mp4 without an ffmpeg backend becomes
    a gif. Returns the path written."""
    require()
    import imageio

    kwargs = {"duration": 1000.0 / fps} if path.endswith(".gif") else {"fps": fps}
    try:
        imageio.mimsave(path, frames, **kwargs)
    except Exception:
        if path.endswith(".gif"):
            raise
        path = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimsave(path, frames, duration=1000.0 / fps)
    return path
