"""13-state single-rigid-body model for convex MPC (port of quadruped_tpu/dynamics/srb.py).

State x = [roll, pitch, yaw, px, py, pz, wx, wy, wz, vx, vy, vz, g] with
w, v in the world frame; controls are 4 x 3 world-frame ground forces. The
continuous A is nilpotent (A^3 = 0, A^2 B = 0), so the zero-order hold has
the exact closed form Ad = I + A dt + A^2 dt^2/2, Bd = B dt + A B dt^2/2.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_tpu_torch.core import se3

NX = 13
NU = 12
GRAVITY = -9.8  # reference MPC constant (9.81 is used for fMax only)


def world_inertia(inertia_body: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """World-frame inertia I_w = R I_body R^T, [..., 3, 3]."""
    return se3.matmul3(se3.matmul3(rot, inertia_body), rot.transpose(-1, -2))


def srb_continuous(rot: torch.Tensor, inertia_body: torch.Tensor,
                   mass: torch.Tensor, r_feet: torch.Tensor):
    """Continuous-time (A [..., 13, 13], B [..., 13, 12]).

    rot: [..., 3, 3] body->world rotation (a [...] yaw is promoted to
    Rz(yaw)); r_feet: [..., 4, 3] foot positions relative to the CoM,
    world frame.
    """
    if rot.ndim < 2 or rot.shape[-1] != 3:
        rot = se3.rot_z(rot)
    batch = torch.broadcast_shapes(rot.shape[:-2], inertia_body.shape[:-2],
                                   mass.shape, r_feet.shape[:-2])
    dtype, device = r_feet.dtype, r_feet.device

    rz_t = rot.transpose(-1, -2).expand(batch + (3, 3))
    z33 = torch.zeros(batch + (3, 3), dtype=dtype, device=device)
    z31 = torch.zeros(batch + (3, 1), dtype=dtype, device=device)
    rows_rpy = torch.cat([z33, z33, rz_t, z33, z31], dim=-1)
    static = np.zeros((NX - 3, NX), np.float32)
    static[0:3, 9:12] = np.eye(3)
    static[8, 12] = 1.0
    rows_static = torch.as_tensor(static, dtype=dtype, device=device) \
        .expand(batch + (NX - 3, NX))
    a = torch.cat([rows_rpy, rows_static], dim=-2)

    i_world_inv = se3.inv3x3(world_inertia(inertia_body, rot))
    torque_maps = se3.matmul3(i_world_inv[..., None, :, :], se3.skew(r_feet))
    tq = torque_maps.transpose(-3, -2).reshape(batch + (3, NU))
    eye_tiled = torch.as_tensor(np.tile(np.eye(3, dtype=np.float32), (1, 4)),
                                dtype=dtype, device=device)
    rows_v = eye_tiled.expand(batch + (3, NU)) / mass[..., None, None]
    z6 = torch.zeros(batch + (6, NU), dtype=dtype, device=device)
    z1 = torch.zeros(batch + (1, NU), dtype=dtype, device=device)
    b = torch.cat([z6, tq, rows_v, z1], dim=-2)
    return a, b


def srb_discretize(a: torch.Tensor, b: torch.Tensor, dt):
    """Exact ZOH for the nilpotent SRB A."""
    eye = torch.eye(NX, dtype=a.dtype, device=a.device)
    ad = eye + a * dt + (a @ a) * (dt * dt * 0.5)
    bd = b * dt + (a @ b) * (dt * dt * 0.5)
    return ad, bd


def srb_initial_state(rpy, pos, omega_world, vel_world) -> torch.Tensor:
    """Pack the 13-state vector (appends the gravity state)."""
    parts = [rpy, pos, omega_world, vel_world]
    batch = torch.broadcast_shapes(*[p.shape[:-1] for p in parts])
    g = torch.full(batch + (1,), GRAVITY, dtype=rpy.dtype, device=rpy.device)
    return torch.cat([p.expand(batch + (3,)) for p in parts] + [g], dim=-1)
