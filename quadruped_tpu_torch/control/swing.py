"""Raibert swing-leg controller (port of quadruped_tpu/control/swing.py).

Per-leg masked arithmetic over [B, 4, 3]: lift-off latching, the foothold
law of the mode (the advanced-trot heuristic, or the velocity-mode Raibert
law for every other mode), the touchdown-wait probe, the optional terrain
hook `SwingConfig.foothold_adjust_fn`, the swing curve, and IK to joint
targets. The gait table may be shared by the batch or per scenario.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       DesiredStateCommand)
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import se3, splines
from quadruped_tpu_torch.gait.scheduler import GaitConfig, GaitState, LegState
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import SIDE_SIGN, RobotParams


class SplineType:
    PARABOLA = 0
    CUBIC = 1
    BSPLINE = 2


_SWING_FNS = {SplineType.PARABOLA: splines.swing_parabola,
              SplineType.CUBIC: splines.swing_cubic,
              SplineType.BSPLINE: splines.swing_bspline}


@dataclasses.dataclass
class SwingConfig:
    swing_kp: tuple = (0.03, 0.03, 0.03)
    foot_clearance: float = 0.01
    swing_height: float = 0.1
    foothold_clip: float = 0.2
    foothold_forward_gain: float = 0.0
    mode: int = ControlMode.ADVANCED_TROT
    spline_type: int = SplineType.PARABOLA
    # Terrain foothold hook: world-frame targets [B, 4, 3] -> [B, 4, 3]
    # (e.g. a planner.foot_stepper.adjust_footholds_for_gaps partial).
    foothold_adjust_fn: object = None


@dataclasses.dataclass
class SwingState:
    liftoff_pos_base: torch.Tensor    # [B, 4, 3]
    liftoff_pos_world: torch.Tensor   # [B, 4, 3] translated-world latch
    foot_target_base: torch.Tensor    # [B, 4, 3]
    foot_target_world: torch.Tensor   # [B, 4, 3]
    wbc_pfoot_des: torch.Tensor       # [B, 4, 3]
    wbc_vfoot_des: torch.Tensor       # [B, 4, 3]
    wbc_afoot_des: torch.Tensor       # [B, 4, 3]


def _rotate(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v per leg: r [B, 3, 3], v [B, 4, 3]."""
    return torch.einsum("bij,blj->bli", r, v)


def _rotate_t(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v per leg."""
    return torch.einsum("bji,blj->bli", r, v)


def swing_init(params: RobotParams, obs: RobotObservation) -> SwingState:
    p = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    p_world = _rotate(obs.rot_body_to_world, p)
    p_abs = p_world + obs.base_position[:, None, :]
    return SwingState(
        liftoff_pos_base=p, liftoff_pos_world=p_world,
        foot_target_base=p.clone(), foot_target_world=p_abs,
        wbc_pfoot_des=p_abs.clone(), wbc_vfoot_des=torch.zeros_like(p),
        wbc_afoot_des=torch.zeros_like(p))


def _twisting_vector(hip_offset: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] -> [..., 4, 3]: yaw-rate lever arm (-y, x, 0) per hip."""
    return torch.stack([-hip_offset[..., 1], hip_offset[..., 0],
                        torch.zeros_like(hip_offset[..., 0])], dim=-1)


def raibert_foothold_velocity_mode(config: SwingConfig, params: RobotParams,
                                   gait_config: GaitConfig,
                                   obs: RobotObservation,
                                   des: DesiredStateCommand) -> torch.Tensor:
    """[B, 4, 3] velocity-mode foothold targets, base frame: hip velocity *
    stance/2 - Kp (v_target - v) under the hip, at -desired height."""
    hip = params.default_hip_position + params.com_offset
    twist = _twisting_vector(hip)
    r_mat = obs.rot_body_to_world
    v_base = torch.einsum("bi,bij->bj", obs.base_vel_world, r_mat)
    yaw_dot = obs.base_omega_body[:, 2, None, None]
    hip_v = v_base[:, None, :] + yaw_dot * twist
    hip_v[..., 2] = 0.0
    target_v = des.velocity[:, None, :] + des.omega[:, 2, None, None] * twist
    kp = torch.as_tensor(config.swing_kp, dtype=hip.dtype, device=hip.device)
    foothold = (hip_v * gait_config.stance_duration[..., None] * 0.5
                - kp * (target_v - hip_v))
    foothold = foothold + torch.stack(
        [hip[:, 0], hip[:, 1], torch.zeros_like(hip[:, 0])], dim=-1)
    zero = torch.zeros_like(des.position[:, 2])
    height = torch.stack([zero, zero,
                          des.position[:, 2] - config.foot_clearance], -1)
    return foothold - torch.einsum("bji,bj->bi", r_mat, height)[:, None, :]


def heuristic_foothold_advanced(config: SwingConfig, params: RobotParams,
                                gait_config: GaitConfig,
                                gait_state: GaitState, obs: RobotObservation,
                                des: DesiredStateCommand) -> torch.Tensor:
    """[B, 4, 3] advanced-trot foothold targets, base frame."""
    hip = params.hip_offset
    twist = _twisting_vector(hip)
    r_mat = obs.rot_body_to_world
    b = r_mat.shape[0]
    v_base = torch.einsum("bi,bij->bj", obs.base_vel_world, r_mat)
    omega = obs.base_omega_body
    hip_v = v_base[:, None, :] + torch.linalg.cross(
        omega[:, None, :].expand(b, 4, 3), hip.expand(b, 4, 3), dim=-1)
    hip_v[..., 2] = 0.0
    target_v = des.velocity[:, None, :] + des.omega[:, 2, None, None] * twist
    kp = torch.as_tensor(config.swing_kp, dtype=hip.dtype, device=hip.device)
    dp = (target_v * gait_state.swing_time_remaining[:, :, None]
          - kp * (target_v - hip_v)
          + config.foothold_forward_gain * target_v
          * gait_config.stance_duration[..., None])
    dp = torch.clamp(dp, -config.foothold_clip, config.foothold_clip)
    dp[..., 2] = 0.0

    roll_r = se3.rot_x(obs.base_rpy[:, 0])
    interleave = params.hip_length * torch.as_tensor(
        SIDE_SIGN, dtype=hip.dtype, device=hip.device)
    zero4 = torch.zeros_like(interleave)
    hip_link = torch.stack([zero4, interleave, zero4], dim=-1)
    hip_world = torch.einsum("bij,lj->bli", roll_r, hip_link)
    target = dp + torch.stack([hip[:, 0], hip[:, 1], zero4], dim=-1) \
        + hip_world
    rear_drop = torch.where(des.velocity[:, 0] < -0.01, 0.02, 0.0)
    target[:, 2:, 0] -= rear_drop[:, None]
    zero = torch.zeros_like(rear_drop)
    height = torch.stack([zero, zero,
                          des.position[:, 2] - config.foot_clearance], -1)
    return target - torch.einsum("bji,bj->bi", r_mat, height)[:, None, :]


def swing_step(config: SwingConfig, params: RobotParams,
               gait_config: GaitConfig, gait_state: GaitState,
               state: SwingState, obs: RobotObservation,
               des: DesiredStateCommand):
    """One swing-controller tick.

    Returns (q_des [B, 12], dq_des [B, 12], swing_joint_mask [B, 12],
    new state).
    """
    r_mat = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    foot_world = _rotate(r_mat, foot_base)

    first = gait_state.first_swing[:, :, None] > 0.5
    liftoff_base = torch.where(first, foot_base, state.liftoff_pos_base)
    liftoff_world = torch.where(first, foot_world, state.liftoff_pos_world)

    if config.mode == ControlMode.ADVANCED_TROT:
        target_base = heuristic_foothold_advanced(config, params, gait_config,
                                                  gait_state, obs, des)
    else:
        target_base = raibert_foothold_velocity_mode(config, params,
                                                     gait_config, obs, des)
    # Touchdown-wait probe: a blocked leg creeps toward the hip line in y
    # and 2 cm down, evaluated at the spline end.
    blocked = gait_state.allow_switch < 0.5
    hip_def = params.default_hip_position
    rel = _rotate(r_mat, foot_base - hip_def)
    y_rel = rel[..., 1]
    y_rel = torch.where(y_rel > 0.01, y_rel - 0.005,
                        torch.where(y_rel < -0.01, y_rel + 0.005, y_rel))
    rel = torch.stack([rel[..., 0], y_rel, rel[..., 2] - 0.02], dim=-1)
    probe_base = _rotate_t(r_mat, rel) + hip_def

    swinging = (gait_state.leg_state == LegState.SWING)[:, :, None]
    target_base = torch.where(swinging, target_base, state.foot_target_base)
    target_base = torch.where(blocked[:, :, None], probe_base, target_base)
    target_world = _rotate(r_mat, target_base) + obs.base_position[:, None, :]
    if config.foothold_adjust_fn is not None:
        target_world = config.foothold_adjust_fn(target_world)
        target_base = _rotate_t(r_mat,
                                target_world - obs.base_position[:, None, :])

    phi = torch.where(blocked, 1.0, gait_state.normalized_phase)
    target_rot = _rotate(r_mat, target_base)
    pos_w, vel_w = _SWING_FNS[config.spline_type](
        liftoff_world, target_rot, config.swing_height, phi)
    pos_base = _rotate_t(r_mat, pos_w)
    vel_base = _rotate_t(r_mat, vel_w) \
        / torch.clamp(gait_config.swing_duration, min=1e-4)[..., None]

    q_des = kinematics.joint_angles_from_foot_positions(params, pos_base)
    jac = kinematics.all_leg_jacobians(params, q_des)
    dq_des = kinematics.damped_jacobian_solve(jac, vel_base)
    dq_des = dq_des.reshape(q_des.shape)

    ls = gait_state.leg_state
    swing_leg = ((ls == LegState.SWING) | (ls == LegState.USERDEFINED_SWING)
                 | blocked)
    joint_mask = torch.repeat_interleave(swing_leg.float(), 3, dim=-1)

    new_state = SwingState(
        liftoff_pos_base=liftoff_base, liftoff_pos_world=liftoff_world,
        foot_target_base=target_base, foot_target_world=target_world,
        wbc_pfoot_des=pos_w + obs.base_position[:, None, :],
        wbc_vfoot_des=obs.base_vel_world[:, None, :]
        + _rotate(r_mat, vel_base),
        wbc_afoot_des=torch.zeros_like(pos_w))
    return q_des, dq_des, joint_mask, new_state
