"""Base pose estimator: height from the stance feet, planar odometry
(port of quadruped_tpu/estimation/pose.py)."""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.utils import card


@dataclasses.dataclass
class PoseEstimatorState:
    position: torch.Tensor           # [B, 3] world estimate
    yaw_odom: torch.Tensor           # [B] integrated heading
    height_in_control: torch.Tensor  # [B] height along the ground normal


def pose_estimator_init(batch: int, body_height=0.27,
                        device=None) -> PoseEstimatorState:
    device = card.resolve(device)
    h = torch.as_tensor(body_height, dtype=torch.float32, device=device)
    position = torch.zeros(batch, 3, device=device)
    position[:, 2] = h
    return PoseEstimatorState(position=position,
                              yaw_odom=torch.zeros(batch, device=device),
                              height_in_control=h.expand(batch).clone())


def pose_estimator_update(state: PoseEstimatorState,
                          *,
                          quat: torch.Tensor,                 # [B, 4]
                          foot_positions_base: torch.Tensor,  # [B, 4, 3]
                          desired_stance: torch.Tensor,       # [B, 4]
                          v_base: torch.Tensor,               # [B, 3]
                          yaw_rate: torch.Tensor,             # [B]
                          ground_rot: torch.Tensor,           # [B, 3, 3]
                          body_height,
                          dt) -> PoseEstimatorState:
    r = se3.quat_to_rotmat(quat)
    feet_world = torch.einsum("bij,blj->bli", r, foot_positions_base)
    n = torch.sum(desired_stance, dim=-1)
    n1 = torch.clamp(n, min=1.0)
    height = torch.sum(-feet_world[..., 2] * desired_stance, dim=-1) / n1
    height = torch.where(n > 0.5, height, body_height)

    feet_control = torch.einsum("bji,blj->bli", ground_rot, feet_world)
    h_control = torch.sum(-feet_control[..., 2] * desired_stance,
                          dim=-1) / n1
    h_control = torch.where(n > 0.5, h_control, body_height)

    # Planar odometry.
    theta = state.yaw_odom
    dx = (v_base[:, 0] * torch.cos(theta)
          - v_base[:, 1] * torch.sin(theta)) * dt
    dy = (v_base[:, 0] * torch.sin(theta)
          + v_base[:, 1] * torch.cos(theta)) * dt
    pos = torch.stack([state.position[:, 0] + dx, state.position[:, 1] + dy,
                       height], dim=-1)
    return PoseEstimatorState(position=pos, yaw_odom=theta + yaw_rate * dt,
                              height_in_control=h_control)
