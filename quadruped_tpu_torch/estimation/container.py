"""Estimator container: runs the estimators of one tick in order (port of
quadruped_tpu/estimation/container.py).

Contact detection first (it feeds everything downstream), then the ground
plane, the velocity filter and the pose, producing the `RobotObservation`
the controllers see.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.estimation.contact import (ContactDetectionState,
                                                    contact_detection_init,
                                                    contact_detection_update)
from quadruped_tpu_torch.estimation.ground import (GroundEstimatorState,
                                                   ground_estimator_init,
                                                   ground_estimator_update,
                                                   height_in_plane)
from quadruped_tpu_torch.estimation.pose import (PoseEstimatorState,
                                                 pose_estimator_init,
                                                 pose_estimator_update)
from quadruped_tpu_torch.estimation.velocity import (
    VelocityEstimatorConfig, VelocityEstimatorState, velocity_estimator_init,
    velocity_estimator_update)
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.utils import card


@dataclasses.dataclass
class EstimatorConfig:
    velocity: VelocityEstimatorConfig


@dataclasses.dataclass
class EstimatorState:
    velocity: VelocityEstimatorState
    pose: PoseEstimatorState
    ground: GroundEstimatorState
    contact: ContactDetectionState


@dataclasses.dataclass
class RawSensors:
    """What a robot measures, batch-first."""

    quat: torch.Tensor              # [B, 4] IMU orientation
    acc_body: torch.Tensor          # [B, 3] IMU linear acceleration
    omega_body: torch.Tensor        # [B, 3] gyro
    joint_angles: torch.Tensor      # [B, 12]
    joint_velocities: torch.Tensor  # [B, 12]
    foot_forces: torch.Tensor       # [B, 4] foot force sensors


def estimator_init(config: EstimatorConfig, batch: int, body_height=0.27,
                   device=None) -> EstimatorState:
    device = card.resolve(device)
    return EstimatorState(
        velocity=velocity_estimator_init(config.velocity, batch, device),
        pose=pose_estimator_init(batch, body_height, device),
        ground=ground_estimator_init(batch, device),
        contact=contact_detection_init(batch, device=device))


def estimator_update(config: EstimatorConfig, params: RobotParams,
                     state: EstimatorState, sensors: RawSensors,
                     *,
                     normalized_phase: torch.Tensor,  # [B, 4] gait phase
                     desired_stance: torch.Tensor,    # [B, 4]
                     dt) -> tuple[EstimatorState, RobotObservation]:
    """One estimation tick -> (state', RobotObservation)."""
    r = se3.quat_to_rotmat(sensors.quat)
    p_feet = kinematics.foot_positions_in_base_frame(params,
                                                     sensors.joint_angles)
    v_feet = kinematics.foot_velocities_in_base_frame(
        params, sensors.joint_angles, sensors.joint_velocities)

    # Contact detection first (feeds everything downstream).
    dz = p_feet[..., 2] - height_in_plane(state.ground.plane_coefs,
                                          p_feet[..., :2])
    v_base_prev = torch.einsum("bj,bji->bi",
                               state.velocity.smoothed_v_world, r)
    contact_state = contact_detection_update(
        state.contact, normalized_phase=normalized_phase,
        in_stance=desired_stance, foot_height_above_ground=dz,
        foot_velocities_base=v_feet, foot_forces=sensors.foot_forces,
        base_v_control=v_base_prev)
    contact = contact_state.is_contact

    ground_state = ground_estimator_update(state.ground, p_feet, contact,
                                           sensors.quat)

    vel_state = velocity_estimator_update(
        config.velocity, params, state.velocity,
        acc_body=sensors.acc_body, quat=sensors.quat,
        omega_body=sensors.omega_body, joint_angles=sensors.joint_angles,
        joint_velocities=sensors.joint_velocities, foot_contact=contact,
        dt=dt)

    v_base = torch.einsum("bj,bji->bi", vel_state.smoothed_v_world, r)
    pose_state = pose_estimator_update(
        state.pose, quat=sensors.quat, foot_positions_base=p_feet,
        desired_stance=desired_stance, v_base=v_base,
        yaw_rate=sensors.omega_body[:, 2],
        ground_rot=ground_state.ground_rot, body_height=params.body_height,
        dt=dt)

    obs = RobotObservation(
        base_position=pose_state.position,
        base_rpy=se3.quat_to_rpy(sensors.quat),
        base_quat=sensors.quat,
        base_vel_world=vel_state.smoothed_v_world,
        base_omega_world=torch.einsum("bij,bj->bi", r, sensors.omega_body),
        base_omega_body=sensors.omega_body,
        joint_angles=sensors.joint_angles,
        joint_velocities=sensors.joint_velocities,
        foot_contact=contact,
        foot_forces=sensors.foot_forces)
    new_state = EstimatorState(velocity=vel_state, pose=pose_state,
                               ground=ground_state, contact=contact_state)
    return new_state, obs
