"""3-D robot-state renders: skeleton frames and animated GIFs of rollouts
(port of quadruped_tpu/utils/viz3d.py).

Host-side matplotlib 3-D axes (Agg backend, no display): trunk loop,
hip-knee-foot leg chains, foot-contact markers and a ground or terrain
wireframe, as PNG panels (`snapshot`) or an animated GIF
(`animate_rollout`). The skeleton comes from the port's own kinematics
(`core.se3.rpy_to_rotmat`, `robots.kinematics.foot_positions_in_base_frame`),
so it matches the controllers' leg conventions for every robot.

A `Viz3DTrace` is time-first, as in the JAX package: position [T, 3],
rpy [T, 3], joint angles [T, 12], optional contact [T, 4], with any batch
axes after time (pick one with `scenario=`). The port's loops keep the
scenario axis first, so a trace of them is `torch.stack` of per-tick
tensors along dim 0. A `terrain` callable takes and returns tensors
(`terrain(x, y) -> z`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams

DT = 0.002


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Viz3DTrace(NamedTuple):
    """Per-tick pose trace ([T, ...]; batch axes after time allowed)."""

    position: np.ndarray       # [T, 3] base world position
    rpy: np.ndarray            # [T, 3]
    joint_angles: np.ndarray   # [T, 12]
    contact: np.ndarray | None = None   # [T, 4] optional


def skeleton_points(params: RobotParams, position, rpy, q):
    """World-frame skeleton of one frame of one robot (`params` of one
    robot): (trunk [5, 3] corner loop FR FL RL RR FR, legs [4, 3, 3] hip /
    knee / foot). The knee is the foot of the same chain with the shank
    length set to zero."""
    device = params.hip_offset.device
    as_t = lambda a: torch.as_tensor(_np(a), dtype=torch.float32,
                                     device=device)
    r = _np(se3.rpy_to_rotmat(as_t(rpy)))
    pos = _np(position).astype(np.float32)
    hips = _np(params.hip_offset)                              # [4, 3]
    qj = as_t(q)
    feet_b = _np(kinematics.foot_positions_in_base_frame(params, qj))
    knee_params = dataclasses.replace(
        params, lower_length=0.0 * params.lower_length)
    knees = _np(kinematics.foot_positions_in_base_frame(knee_params, qj))

    to_world = lambda p: p @ r.T + pos
    trunk = to_world(hips[[0, 1, 3, 2, 0]])
    legs = np.stack([to_world(np.stack([hips[i], knees[i], feet_b[i]]))
                     for i in range(4)])
    return trunk, legs


def render_frame(ax, params: RobotParams, position, rpy, q,
                 contact=None, terrain: Callable | None = None,
                 trail: np.ndarray | None = None):
    """Draw one robot state onto a 3-D axis."""
    trunk, legs = skeleton_points(params, position, rpy, q)
    ax.plot(trunk[:, 0], trunk[:, 1], trunk[:, 2], "-", color="#334455",
            lw=3)
    for i in range(4):
        ax.plot(legs[i, :, 0], legs[i, :, 1], legs[i, :, 2], "-o",
                color="#2277cc", lw=2, ms=2)
        if contact is not None and contact[i] > 0.5:
            ax.scatter(*legs[i, 2], color="#cc3322", s=25)
    if trail is not None:
        ax.plot(trail[:, 0], trail[:, 1], trail[:, 2], "-",
                color="#88aa88", lw=1, alpha=0.7)

    cx, cy = float(position[0]), float(position[1])
    gx, gy = np.meshgrid(np.linspace(cx - 0.5, cx + 0.5, 9),
                         np.linspace(cy - 0.5, cy + 0.5, 9))
    if terrain is not None:
        gz = _np(terrain(torch.as_tensor(gx.ravel(), dtype=torch.float32),
                         torch.as_tensor(gy.ravel(), dtype=torch.float32))
                 ).reshape(gx.shape)
    else:
        gz = np.zeros_like(gx)
    ax.plot_wireframe(gx, gy, gz, color="#bbbbbb", lw=0.4)
    ax.set_xlim(cx - 0.5, cx + 0.5)
    ax.set_ylim(cy - 0.5, cy + 0.5)
    ax.set_zlim(-0.05, 0.55)
    ax.set_box_aspect((1, 1, 0.6))


def animate_rollout(params: RobotParams, trace: Viz3DTrace,
                    path: str = "/tmp/rollout3d.gif", *,
                    every: int = 25, fps: int = 15,
                    scenario: int | tuple | None = None,
                    terrain: Callable | None = None) -> str:
    """Render a rollout trace to an animated GIF (PillowWriter, no ffmpeg);
    `every` ticks a frame, `scenario` indexes the batch axes after time."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation, PillowWriter

    def pick(x):
        if x is None:
            return None
        x = _np(x)
        if scenario is not None:
            idx = (scenario,) if isinstance(scenario, int) else scenario
            x = x[(slice(None),) + idx]
        return x

    pos = pick(trace.position)
    rpy = pick(trace.rpy)
    q = pick(trace.joint_angles)
    contact = pick(trace.contact)
    frames = range(0, pos.shape[0], every)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")

    def draw(k):
        ax.cla()
        render_frame(ax, params, pos[k], rpy[k], q[k],
                     contact=None if contact is None else contact[k],
                     terrain=terrain, trail=pos[: k + 1])
        ax.set_title(f"t = {k * DT:.2f} s")

    anim = FuncAnimation(fig, draw, frames=frames)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def snapshot(params: RobotParams, trace: Viz3DTrace,
             path: str = "/tmp/rollout3d.png", *, ticks=(0,),
             scenario: int | None = None,
             terrain: Callable | None = None) -> str:
    """Static multi-panel render, one subplot per tick of `ticks`."""
    plt = _plt()
    pos, rpy, q = (_np(x) for x in
                   (trace.position, trace.rpy, trace.joint_angles))
    contact = None if trace.contact is None else _np(trace.contact)
    if scenario is not None:
        pos, rpy, q = pos[:, scenario], rpy[:, scenario], q[:, scenario]
        if contact is not None:
            contact = contact[:, scenario]

    n = len(ticks)
    fig = plt.figure(figsize=(5 * n, 4.5))
    for j, k in enumerate(ticks):
        ax = fig.add_subplot(1, n, j + 1, projection="3d")
        render_frame(ax, params, pos[k], rpy[k], q[k],
                     contact=None if contact is None else contact[k],
                     terrain=terrain, trail=pos[: k + 1])
        ax.set_title(f"t = {k * DT:.2f} s")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
