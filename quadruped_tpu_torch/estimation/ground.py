"""Ground-surface estimator: plane fit through the stance feet and the
control frame (port of quadruped_tpu/estimation/ground.py).

On four-contact touch-down ticks, least-squares fit z = a0 + a1 x + a2 y
through the base-frame feet (3x3 normal equations through
`core.linalg.inv_spd`), derive the ground normal, and low-pass the
yaw-aligned control frame whose z axis follows it.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.utils import card

RPY_LOWPASS = 0.8


@dataclasses.dataclass
class GroundEstimatorState:
    plane_coefs: torch.Tensor        # [B, 3] (a0, a1, a2) in base frame
    normal_world: torch.Tensor       # [B, 3]
    control_rpy: torch.Tensor        # [B, 3] low-passed ground orientation
    ground_rot: torch.Tensor         # [B, 3, 3] world -> control
    base_r_in_control: torch.Tensor  # [B, 3, 3]
    last_contact: torch.Tensor       # [B, 4]


def ground_estimator_init(batch: int, device=None) -> GroundEstimatorState:
    device = card.resolve(device)
    eye = torch.eye(3, device=device).expand(batch, 3, 3)
    normal = torch.zeros(batch, 3, device=device)
    normal[:, 2] = 1.0
    return GroundEstimatorState(
        plane_coefs=torch.zeros(batch, 3, device=device),
        normal_world=normal, control_rpy=torch.zeros(batch, 3, device=device),
        ground_rot=eye.clone(), base_r_in_control=eye.clone(),
        last_contact=torch.zeros(batch, 4, device=device))


def fit_plane(foot_positions: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] base-frame feet -> [..., 3] (a0, a1, a2) of the least
    squares plane z = a0 + a1 x + a2 y."""
    ones = torch.ones_like(foot_positions[..., 0:1])
    w = torch.cat([ones, foot_positions[..., 0:1], foot_positions[..., 1:2]],
                  dim=-1)                                   # [..., 4, 3]
    ww = w.transpose(-1, -2) @ w
    rhs = torch.einsum("...ij,...i->...j", w, foot_positions[..., 2])
    return torch.einsum("...ij,...j->...i", linalg.inv_spd(ww), rhs)


def ground_estimator_update(state: GroundEstimatorState,
                            foot_positions_base: torch.Tensor,  # [B, 4, 3]
                            contact: torch.Tensor,              # [B, 4]
                            quat: torch.Tensor) -> GroundEstimatorState:
    """One tick; refits only on 4-contact touch-down ticks."""
    new_touch = torch.amax(contact * (1.0 - state.last_contact), dim=-1)
    all_contact = torch.sum(contact, dim=-1) > 3.5
    should_update = (new_touch > 0.5) & all_contact
    upd = should_update[:, None]

    coefs = torch.where(upd, fit_plane(foot_positions_base),
                        state.plane_coefs)

    # Normal in base frame: normalize([-a1, -a2, 1]); rotate to world.
    r = se3.quat_to_rotmat(quat)
    n_base = torch.stack([-coefs[:, 1], -coefs[:, 2],
                          torch.ones_like(coefs[:, 0])], dim=-1)
    n_base = n_base / torch.linalg.vector_norm(n_base, dim=-1, keepdim=True)
    n_world = torch.einsum("bij,bj->bi", r, n_base)
    n_world = torch.where(n_world[:, 2:3] < 0, -n_world, n_world)
    n_world = torch.where(upd, n_world, state.normal_world)

    # Control frame: yaw from the base, roll/pitch from the ground normal,
    # low-passed.
    yaw = se3.quat_to_rpy(quat)[:, 2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    pitch_g = torch.atan2(n_world[:, 0] * cy + n_world[:, 1] * sy,
                          n_world[:, 2])
    roll_g = torch.atan2(n_world[:, 1] * cy - n_world[:, 0] * sy,
                         n_world[:, 2])
    target_rpy = torch.stack([-roll_g, pitch_g, yaw], dim=-1)
    control_rpy = RPY_LOWPASS * state.control_rpy \
        + (1 - RPY_LOWPASS) * target_rpy
    ground_rot = se3.rpy_to_rotmat(control_rpy)
    base_r_in_control = ground_rot.transpose(-1, -2) @ r
    return GroundEstimatorState(
        plane_coefs=coefs, normal_world=n_world, control_rpy=control_rpy,
        ground_rot=ground_rot, base_r_in_control=base_r_in_control,
        last_contact=contact)


def height_in_plane(coefs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """z of the fitted plane at base-frame points: coefs [B, 3], xy
    [B, N, 2] -> [B, N]."""
    return (coefs[..., 0:1] + coefs[..., 1:2] * xy[..., 0]
            + coefs[..., 2:3] * xy[..., 1])
