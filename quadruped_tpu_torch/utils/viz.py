"""Rollout plots: height, velocity and stance-force traces, gait diagrams
(port of quadruped_tpu/utils/viz.py).

Host-side matplotlib (Agg backend) on the traces the rollouts
return. The port's traces are batch-first ([B, T, ...]); the plots draw
one line a scenario against time. Every function returns None when
matplotlib is not installed, as the JAX module does on headless machines.
"""

from __future__ import annotations

import numpy as np
import torch

LEGS = ("FR", "FL", "RR", "RL")


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def plot_rollout(result, path: str = "/tmp/rollout.png", dt: float = 0.002,
                 batch_index=None):
    """Plot height / velocity / stance-force traces of a RolloutResult
    (sim/rollout.py) or any object with base_height_trace [B, T],
    vel_trace [B, T, 3] and forces_trace [B, T, 4, 3]; `batch_index`
    picks scenarios. Returns the path."""
    plt = _plt()
    if plt is None:
        return None
    hs = _np(result.base_height_trace)
    vs = _np(result.vel_trace)
    fs = _np(result.forces_trace)
    if batch_index is not None:
        hs, vs, fs = hs[batch_index], vs[batch_index], fs[batch_index]
    # Time first, as matplotlib draws one line per column.
    hs, vs, fs = (np.moveaxis(a, -1 - extra, 0) for a, extra in
                  ((hs, 0), (vs, 1), (fs, 2)))
    t = np.arange(hs.shape[0]) * dt

    fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
    axes[0].plot(t, hs)
    axes[0].set_ylabel("CoM height [m]")
    axes[1].plot(t, vs[..., 0], label="vx")
    axes[1].plot(t, vs[..., 1], label="vy")
    axes[1].legend(loc="upper right")
    axes[1].set_ylabel("world velocity [m/s]")
    for leg, name in enumerate(LEGS):
        axes[2].plot(t, fs[..., leg, 2], label=name, lw=0.8)
    axes[2].legend(loc="upper right", ncol=4)
    axes[2].set_ylabel("stance fz [N]")
    axes[2].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_gait_diagram(leg_states, path: str = "/tmp/gait.png",
                      dt: float = 0.002):
    """Gait diagram: [T, 4] leg states -> stance bars per leg (states 1
    and 2 are stance). Returns the path."""
    plt = _plt()
    if plt is None:
        return None
    ls = _np(leg_states)
    t = np.arange(ls.shape[0]) * dt
    fig, ax = plt.subplots(figsize=(9, 2.5))
    for leg in range(4):
        stance = (ls[:, leg] == 1) | (ls[:, leg] == 2)
        ax.fill_between(t, leg + 0.1, leg + 0.9, where=stance, step="post")
    ax.set_yticks([0.5, 1.5, 2.5, 3.5])
    ax.set_yticklabels(LEGS)
    ax.set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
