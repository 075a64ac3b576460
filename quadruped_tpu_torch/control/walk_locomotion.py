"""Statically-stable WALK locomotion: one tick, batched (port of quadruped_tpu/control/walk_locomotion.py).

The reference's WALK_LOCOMOTION mode: the walk gait's sub-state machine
(gait/walk.py), the pose planner that shifts the base over the support
polygon of the legs that stay down (planner/pose_planner.py), the
force-balance stance controller with per-leg load/unload force ramps, and
a swing spline for the TRUE_SWING leg only. Per tick:

  1. advance the walk gait;
  2. when a leg enters its pre-swing window, replan the base pose over
     the future support polygon (the SQP runs only on such ticks) and
     track the interpolated pose setpoint;
  3. stance, load and unload legs get force-balance torques with ramped
     force bounds; the TRUE_SWING leg follows its swing spline.

The robot is one model or a fleet (`params.stack_params`, one robot per
scenario).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control import stance_force_balance as stance_fb
from quadruped_tpu_torch.control.desired_state import (DesiredStateCommand,
                                                       TwistCommand,
                                                       desired_state_init,
                                                       desired_state_update)
from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.core import se3, splines
from quadruped_tpu_torch.gait.scheduler import GaitConfig, LegState
from quadruped_tpu_torch.gait.walk import (SubLegState, WalkGaitState,
                                           load_ratios, walk_gait_init,
                                           walk_gait_update)
from quadruped_tpu_torch.planner.pose_planner import (PosePlannerState,
                                                      intermediate_base_pose,
                                                      pose_planner_init,
                                                      pose_planner_update)
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import (RobotParams, check_batch,
                                               rotate_legs)

STANCE_KD = 3.0


@dataclasses.dataclass
class WalkConfig:
    gait: GaitConfig
    force_balance: stance_fb.ForceBalanceConfig
    swing_height: float = 0.08
    step_length: float = 0.08
    # True: the reference's support-polygon SQP; False: the centroid
    # heuristic.
    use_sqp_pose_planner: bool = True


@dataclasses.dataclass
class WalkState:
    gait: WalkGaitState
    pose: PosePlannerState
    command: DesiredStateCommand
    liftoff_pos_world: torch.Tensor    # [B, 4, 3] swing lift-off latch
    foot_target_world: torch.Tensor    # [B, 4, 3]
    prev_sub_state: torch.Tensor       # [B, 4] int32
    # The previous tick's contact forces: the force-balance QP's warm
    # start when ForceBalanceConfig.warm_start is on.
    warm_forces: torch.Tensor          # [B, 4, 3]


def _feet_world(params: RobotParams, obs: RobotObservation) -> torch.Tensor:
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    return torch.einsum("bij,blj->bli", obs.rot_body_to_world, foot_base) \
        + obs.base_position[:, None]


def walk_init(config: WalkConfig, params: RobotParams,
              obs: RobotObservation) -> WalkState:
    b, device = obs.base_position.shape[0], obs.base_position.device
    check_batch(params, b)
    feet_world = _feet_world(params, obs)
    return WalkState(
        gait=walk_gait_init(config.gait, b),
        pose=pose_planner_init(b, device),
        command=desired_state_init(b, params.body_height, device),
        liftoff_pos_world=feet_world, foot_target_world=feet_world.clone(),
        prev_sub_state=torch.full((b, 4), LegState.STANCE, dtype=torch.int32,
                                  device=device),
        warm_forces=torch.zeros_like(feet_world))


def walk_step(config: WalkConfig, params: RobotParams, state: WalkState,
              obs: RobotObservation, cmd: TwistCommand, t: torch.Tensor,
              terrain_height=None, ground_rpy=None, foothold_adjust_fn=None):
    """One walk tick. t: [B]. Returns (HybridCommand, forces_world
    [B, 4, 3], new state).

    `terrain_height(x, y)` (sim/terrain.py) grounds the swing targets on
    uneven terrain; `ground_rpy` ([3] or [B, 3]) aligns the planned base
    pose and the friction pyramids with the slope; `foothold_adjust_fn`
    (world targets [B, 4, 3], current feet [B, 4, 3] -> [B, 4, 3]) is the
    terrain foothold hook (e.g. planner.foot_stepper.stair_foothold_adjust
    holding feet short of a riser), applied before the z grounding."""
    des = desired_state_update(state.command, cmd)
    gait = walk_gait_update(config.gait, state.gait, t, obs.foot_contact)
    r = obs.rot_body_to_world
    base = obs.base_position[:, None]
    feet_world = _feet_world(params, obs)
    sub = gait.leg_sub_state

    # Swing bookkeeping: latch lift-off and plan the step target (Raibert
    # placement under the hip, advanced by half the stance window at the
    # commanded velocity, clipped to the step length).
    entering_swing = ((sub == SubLegState.TRUE_SWING)
                      & (state.prev_sub_state != SubLegState.TRUE_SWING))
    liftoff = torch.where(entering_swing[..., None], feet_world,
                          state.liftoff_pos_world)
    v_world = torch.einsum("bij,bj->bi", r, des.velocity)
    stance_time = config.gait.stance_duration[..., 0]
    if stance_time.ndim:
        stance_time = stance_time[:, None]
    offset_xy = torch.clamp(v_world[:, :2] * stance_time * 0.5,
                            -config.step_length, config.step_length)
    hip_world = rotate_legs(params, r, params.default_hip_position) + base
    target = torch.cat([hip_world[..., :2] + offset_xy[:, None],
                        hip_world[..., 2:]], dim=-1)
    if foothold_adjust_fn is not None:
        target = foothold_adjust_fn(target, feet_world)
    target_z = (torch.zeros_like(target[..., 2]) if terrain_height is None
                else terrain_height(target[..., 0], target[..., 1]))
    target = torch.cat([target[..., :2], target_z[..., None]], dim=-1)
    foot_target = torch.where(entering_swing[..., None], target,
                              state.foot_target_world)

    # Pose planner: replan when a leg enters its pre-swing window, over the
    # future support polygon (that leg excluded), so that the base arrives
    # before lift-off. An EARLY_CONTACT leg leaves the swing set.
    early = gait.detected_leg_state == LegState.EARLY_CONTACT
    in_true_swing = (sub == SubLegState.TRUE_SWING) & ~early
    support = (~in_true_swing).to(torch.float32)
    entering_window = ((sub == SubLegState.FULL_STANCE)
                       & (state.prev_sub_state == LegState.STANCE))
    pre_swing = ((sub == SubLegState.FULL_STANCE)
                 | (sub == SubLegState.UNLOAD_FORCE))
    plan_support = (~(pre_swing | in_true_swing)).to(torch.float32)
    replan = torch.amax(entering_window.to(torch.float32), dim=-1)
    pose_state = pose_planner_update(
        state.pose, params, base_position=obs.base_position,
        base_rpy=obs.base_rpy, foot_positions_world=feet_world,
        support_mask=plan_support,
        ground_rpy=(torch.zeros_like(obs.base_rpy) if ground_rpy is None
                    else ground_rpy),
        body_height=des.position[:, 2], replan=replan,
        use_sqp=config.use_sqp_pose_planner)
    pose_des, _ = intermediate_base_pose(pose_state, gait.move_base_phase)
    des_walk = dataclasses.replace(des, position=pose_des[:, :3],
                                   rpy=pose_des[:, 3:6])

    # Stance: force balance with the load/unload ramps; the friction
    # pyramids stand on the ground normal.
    f_min_ratio, f_max_ratio = load_ratios(gait)
    fb_config = dataclasses.replace(config.force_balance, track_xy=True)
    normal = (None if ground_rpy is None
              else se3.rpy_to_rotmat(ground_rpy)[..., :, 2])
    forces = stance_fb.compute_contact_forces(
        fb_config, params, obs, des_walk, support, f_min_ratio=f_min_ratio,
        f_max_ratio=f_max_ratio, surface_normal=normal,
        x_warm=state.warm_forces if fb_config.warm_start else None)
    tau_stance = stance_fb.stance_torques(params, obs, forces, support)

    # Swing: the spline of the TRUE_SWING leg.
    pos_w, _ = splines.swing_parabola(liftoff - base, foot_target - base,
                                      config.swing_height,
                                      gait.normalized_phase)
    q_sw = kinematics.joint_angles_from_foot_positions(
        params, torch.einsum("bji,blj->bli", r, pos_w))
    sw = torch.repeat_interleave(in_true_swing, 3, dim=-1)
    zero = torch.zeros_like(q_sw)
    command = HybridCommand(
        q=torch.where(sw, q_sw, zero),
        kp=torch.where(sw, params.motor_kp, zero), dq=zero,
        kd=torch.where(sw, params.motor_kd,
                       STANCE_KD * torch.repeat_interleave(support, 3, -1)),
        tau=torch.where(sw, zero, tau_stance))
    new_state = WalkState(
        gait=gait, pose=pose_state, command=des, liftoff_pos_world=liftoff,
        foot_target_world=foot_target, prev_sub_state=sub,
        warm_forces=forces)
    return command, forces, new_state
