"""Locomotion controller tick, batched (port of quadruped_tpu/control/locomotion.py).

Online gait transitions (with `gait_b`: control/gait_transition.py, which
may put every scenario on its own table), gait clocks, swing controller,
the stance controller of the mode (convex MPC in ADVANCED_TROT, the
force-balance QP in VELOCITY, POSITION and WALK; POSITION tracks the CoM
adjuster's shift as well), optionally the whole-body controller
(`use_wbc`: every 2nd tick, never on a tick that solves the MPC; its
torques replace the stance torques), and the masked merge of swing and
stance commands into one 12-joint hybrid command. The statically-stable
walk with its pose planner and load ramps is control/walk_locomotion.py.
Every mode and the WBC take one robot or a fleet of robots (stacked
parameters, `params.stack_params`, one robot per scenario).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control import gait_transition as gt_mod
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import stance_force_balance as stance_fb
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control import wbc as wbc_mod
from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       DesiredStateCommand,
                                                       TwistCommand,
                                                       desired_state_init,
                                                       desired_state_update)
from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.dynamics.floating_base import FloatingBaseModel
from quadruped_tpu_torch.gait.scheduler import (GaitConfig, GaitState,
                                                gait_init, gait_update,
                                                stance_contact_mask)
from quadruped_tpu_torch.planner import com_adjuster
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams, check_batch
from quadruped_tpu_torch.utils.logging import span

STANCE_KD = 3.0  # damping on stance joints (reference legCommand {0,0,0,3,tau})
# Forward CoM offset added to the WBC body-position target.
WBC_COM_OFFSET_X = 0.018
# Abad compensation torque per leg, +/-0.9 N*m alternating by side
# (ADVANCED_TROT only).
_HIP_COMP = tuple(0.9 * (-1.0) ** ((leg + 1) % 2) if j == 0 else 0.0
                  for leg in range(4) for j in range(3))


@dataclasses.dataclass
class LocomotionConfig:
    mpc: mpc_mod.MpcConfig
    swing: swing_mod.SwingConfig
    gait: GaitConfig
    wbc: wbc_mod.WbcConfig | None = None   # WbcConfig() when None
    use_wbc: bool = False
    # ADVANCED_TROT -> convex-MPC stance; VELOCITY / POSITION / WALK ->
    # force-balance stance (ForceBalanceConfig() when None).
    mode: int = ControlMode.ADVANCED_TROT
    force_balance: stance_fb.ForceBalanceConfig | None = None
    # Second gait table: a rising edge of TwistCommand.gait_switch toggles
    # a scenario between `gait` and `gait_b` (decel, stance hold, swap).
    gait_b: GaitConfig | None = None


@dataclasses.dataclass
class LocomotionState:
    gait: GaitState
    mpc: mpc_mod.MpcState
    swing: swing_mod.SwingState
    command: DesiredStateCommand
    wbc_iteration: torch.Tensor  # [B] int32
    transition: gt_mod.GaitTransitionState | None = None


def locomotion_init(config: LocomotionConfig, params: RobotParams,
                    obs: RobotObservation,
                    cold_start: bool = True) -> LocomotionState:
    """Initial controller state for the batch of `obs`; with `cold_start`
    in ADVANCED_TROT, one high-budget solve seeds the MPC warm start
    (mpc_cold_start). Raises ValueError when stacked `params` hold another
    number of robots than the batch."""
    b = obs.base_position.shape[0]
    check_batch(params, b)
    device = obs.base_position.device
    gait_state = gait_init(config.gait, b)
    mpc_state = mpc_mod.mpc_init(config.mpc, b, params.body_height, device)
    command = desired_state_init(b, params.body_height, device)
    if cold_start and config.mode == ControlMode.ADVANCED_TROT:
        mpc_state = mpc_mod.mpc_cold_start(config.mpc, params, config.gait,
                                           gait_state, mpc_state, obs,
                                           command)
    return LocomotionState(
        gait=gait_state, mpc=mpc_state,
        swing=swing_mod.swing_init(params, obs), command=command,
        wbc_iteration=torch.zeros(b, dtype=torch.int32, device=device),
        transition=(gt_mod.gait_transition_init(b, device)
                    if config.gait_b is not None else None))


def _wbc_command(state_mpc: mpc_mod.MpcState, swing_state,
                 obs: RobotObservation, gait_state: GaitState,
                 body_height: torch.Tensor) -> wbc_mod.WbcCommand:
    """The WBC's targets from the MPC and swing outputs."""
    r = obs.rot_body_to_world
    zero = torch.zeros_like(state_mpc.x_vel_des)
    v_des_world = torch.einsum("bij,bj->bi", r, torch.stack(
        [state_mpc.x_vel_des, state_mpc.y_vel_des, zero], dim=-1))
    offset = torch.einsum("bij,j->bi", r, torch.as_tensor(
        [WBC_COM_OFFSET_X, 0.0, 0.0], dtype=r.dtype, device=r.device))
    p_des = torch.stack([state_mpc.pos_des_world[:, 0] + offset[:, 0],
                         state_mpc.pos_des_world[:, 1] + offset[:, 1],
                         body_height], dim=-1)
    return wbc_mod.WbcCommand(
        p_body_des=p_des,
        v_body_des=torch.cat([v_des_world[:, :2], zero[:, None]], dim=-1),
        a_body_des=torch.zeros_like(p_des),
        rpy_des=torch.stack([zero, zero, state_mpc.yaw_des], dim=-1),
        omega_des_world=torch.stack([zero, zero, state_mpc.yaw_turn_rate],
                                    dim=-1),
        p_foot_des=swing_state.wbc_pfoot_des,
        v_foot_des=swing_state.wbc_vfoot_des,
        a_foot_des=swing_state.wbc_afoot_des,
        fr_des=state_mpc.forces_world,
        contact_state=stance_contact_mask(gait_state))


def locomotion_step(config: LocomotionConfig, params: RobotParams,
                    state: LocomotionState, obs: RobotObservation,
                    cmd: TwistCommand, t: torch.Tensor,
                    model: FloatingBaseModel | None = None,
                    v_preview: torch.Tensor | None = None,
                    z_preview: torch.Tensor | None = None):
    """One control tick. t: [B] time. Returns (HybridCommand,
    forces_world [B, 4, 3], new state). Pass `model`
    (dynamics.floating_base.build_model) to run the WBC when
    config.use_wbc."""
    with span("qtpu.ctrl"):
        wbc_on = config.use_wbc and model is not None
        any_solve = None
        if wbc_on:
            # The WBC runs every 2nd tick, never on a tick that solves the MPC.
            # One host check covers both: whether any scenario solves and
            # whether any runs the WBC.
            trot = config.mode == ControlMode.ADVANCED_TROT
            solving = (mpc_mod.solve_mask(config.mpc, state.mpc) if trot
                       else torch.zeros_like(state.wbc_iteration,
                                             dtype=torch.bool))
            do_wbc = (state.wbc_iteration % 2 == 0) & ~solving
            with span("qtpu.sync.wbc_gate"):
                any_solve, any_wbc = torch.stack([solving.any(),
                                                  do_wbc.any()]).tolist()
        # The gait transition manager scales the command, may freeze or swap
        # the gait clock, and pins full stance through the hold.
        gait_cfg, gait_pre, hold, trans_state = (config.gait, state.gait, None,
                                                 state.transition)
        if config.gait_b is not None:
            gait_cfg, gait_pre, cmd, hold, trans_state = \
                gt_mod.gait_transition_step(state.transition, state.gait,
                                            config.gait, config.gait_b, cmd, t,
                                            obs.foot_contact)
        des = desired_state_update(state.command, cmd)
        gait_state = gait_update(gait_cfg, gait_pre, t, obs.foot_contact)
        if hold is not None:
            gait_state = gt_mod.hold_stance_gait(hold, gait_state)
        q_sw, dq_sw, swing_mask, swing_state = swing_mod.swing_step(
            config.swing, params, gait_cfg, gait_state, state.swing, obs, des)
        stance = stance_contact_mask(gait_state)
        stance_joint_mask = torch.repeat_interleave(stance, 3, dim=-1)

        if config.mode == ControlMode.ADVANCED_TROT:
            tau_stance, forces_world, _, mpc_state = mpc_mod.mpc_step(
                config.mpc, params, gait_cfg, gait_state, state.mpc, obs, des,
                foot_targets_world=swing_state.foot_target_world,
                v_preview=v_preview, z_preview=z_preview, any_solve=any_solve)
        else:
            # Force-balance stance path; POSITION mode also tracks the CoM
            # adjuster's shift.
            fb_config = config.force_balance or stance_fb.ForceBalanceConfig()
            des_fb = des
            if config.mode == ControlMode.POSITION:
                feet = kinematics.foot_positions_in_base_frame(
                    params, obs.joint_angles)
                com_shift = com_adjuster.com_position_in_base_frame(
                    gait_state, feet)
                des_fb = dataclasses.replace(des, position=torch.cat(
                    [com_shift[:, :2], des.position[:, 2:]], dim=-1))
            forces_world = stance_fb.compute_contact_forces(
                fb_config, params, obs, des_fb, stance)
            tau_stance = stance_fb.stance_torques(params, obs, forces_world,
                                                  stance)
            mpc_state = state.mpc

        if wbc_on and any_wbc:
            wbc_mod._STEP.calls += 1
            with span("qtpu.ctrl.wbc"):
                wbc_cmd = _wbc_command(mpc_state, swing_state, obs,
                                       gait_state, des.position[:, 2])
                _, _, tau_wbc = wbc_mod.wbc_step(
                    config.wbc or wbc_mod.WbcConfig(), params, model, obs,
                    wbc_cmd)
                tau_stance = torch.where(
                    do_wbc[:, None] & (stance_joint_mask > 0.5), tau_wbc,
                    tau_stance)
        elif wbc_on:
            wbc_mod._STEP.skipped += 1

        sw = swing_mask > 0.5
        zero = torch.zeros_like(q_sw)
        tau = torch.where(sw, zero, tau_stance)
        if config.mode == ControlMode.ADVANCED_TROT:
            tau = tau + torch.as_tensor(_HIP_COMP, dtype=torch.float32,
                                        device=q_sw.device)
        command = HybridCommand(
            q=torch.where(sw, q_sw, zero),
            kp=torch.where(sw, params.motor_kp, zero),
            dq=torch.where(sw, dq_sw, zero),
            kd=torch.where(sw, params.motor_kd, STANCE_KD * stance_joint_mask),
            tau=tau,
        )
        new_state = LocomotionState(gait=gait_state, mpc=mpc_state,
                                    swing=swing_state, command=des,
                                    wbc_iteration=state.wbc_iteration + 1,
                                    transition=trans_state)
        return command, forces_world, new_state
