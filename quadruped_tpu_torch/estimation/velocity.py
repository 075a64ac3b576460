"""Base velocity estimator: 3-state Kalman filter + moving-window smoothing
(port of quadruped_tpu/estimation/velocity.py).

Predict the world-frame base velocity from the smoothed IMU acceleration
(R a - g), correct with the mean stance-leg kinematic observation
-R (v_foot + omega x p_foot) (H = I; with no foot in contact the
prediction is its own observation), then smooth through a moving window.
The 3x3 innovation is inverted by `core.linalg.inv_spd`, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.core.filters import (MovingWindowState,
                                              moving_window_init,
                                              moving_window_update)
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.utils import card


@dataclasses.dataclass
class VelocityEstimatorConfig:
    accel_variance: float = 0.1
    sensor_variance: float = 0.1
    initial_variance: float = 0.1
    window_size: int = 120
    acc_filter_window: int = 20


@dataclasses.dataclass
class VelocityEstimatorState:
    v_world: torch.Tensor            # [B, 3] filter state
    cov: torch.Tensor                # [B, 3, 3]
    acc_filter: MovingWindowState    # IMU acceleration smoothing
    vel_filter: MovingWindowState    # output smoothing
    smoothed_v_world: torch.Tensor   # [B, 3]


def velocity_estimator_init(config: VelocityEstimatorConfig, batch: int,
                            device=None) -> VelocityEstimatorState:
    device = card.resolve(device)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    return VelocityEstimatorState(
        v_world=torch.zeros(batch, 3, device=device),
        cov=(eye * config.initial_variance).expand(batch, 3, 3).clone(),
        acc_filter=moving_window_init(batch, config.acc_filter_window, (3,),
                                      device),
        vel_filter=moving_window_init(batch, config.window_size, (3,),
                                      device),
        smoothed_v_world=torch.zeros(batch, 3, device=device))


def _rotate(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bij,bj->bi", r, v)


def velocity_estimator_update(
    config: VelocityEstimatorConfig,
    params: RobotParams,
    state: VelocityEstimatorState,
    *,
    acc_body: torch.Tensor,          # [B, 3] IMU acceleration, body frame
    quat: torch.Tensor,              # [B, 4]
    omega_body: torch.Tensor,        # [B, 3] gyro
    joint_angles: torch.Tensor,      # [B, 12]
    joint_velocities: torch.Tensor,  # [B, 12]
    foot_contact: torch.Tensor,      # [B, 4]
    dt,
) -> VelocityEstimatorState:
    r = se3.quat_to_rotmat(quat)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)

    acc_filter, acc_sm = moving_window_update(state.acc_filter, acc_body)
    acc_world = _rotate(r, acc_sm) + torch.as_tensor(
        [0.0, 0.0, -9.81], dtype=r.dtype, device=r.device)

    # Predict.
    v_pred = state.v_world + acc_world * dt
    cov_pred = state.cov + eye * config.accel_variance

    # Observe: -R (v_foot + omega x p_foot) averaged over contact feet.
    p_feet = kinematics.foot_positions_in_base_frame(params, joint_angles)
    v_feet = kinematics.foot_velocities_in_base_frame(params, joint_angles,
                                                      joint_velocities)
    omega = omega_body[:, None, :].expand_as(p_feet)
    v_obs_per_leg = -torch.einsum(
        "bij,blj->bli", r, v_feet + torch.linalg.cross(omega, p_feet))
    n_contact = torch.sum(foot_contact, dim=-1)
    mean_obs = torch.sum(v_obs_per_leg * foot_contact[..., None], dim=1) \
        / torch.clamp(n_contact, min=1.0)[:, None]
    z = torch.where((n_contact > 0.5)[:, None], mean_obs, v_pred)

    # Kalman update (H = I).
    s = cov_pred + eye * config.sensor_variance
    k = cov_pred @ linalg.inv_spd(s)
    v_new = v_pred + _rotate(k, z - v_pred)
    cov_new = (eye - k) @ cov_pred
    cov_new = 0.5 * (cov_new + cov_new.transpose(-1, -2))

    vel_filter, v_smoothed = moving_window_update(state.vel_filter, v_new)
    return VelocityEstimatorState(
        v_world=v_new, cov=cov_new, acc_filter=acc_filter,
        vel_filter=vel_filter, smoothed_v_world=v_smoothed)
