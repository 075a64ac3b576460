"""Locomotion controller tick, batched (port of quadruped_tpu/control/locomotion.py).

The ADVANCED_TROT branch: gait clocks, swing controller, convex-MPC stance
controller, and the masked merge of swing and stance commands into one
12-joint hybrid command. Not ported yet: the force-balance modes
(VELOCITY / POSITION / WALK), the WBC path (`use_wbc`) and online gait
transitions (`gait_b`); each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       DesiredStateCommand,
                                                       TwistCommand,
                                                       desired_state_init,
                                                       desired_state_update)
from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.gait.scheduler import (GaitConfig, GaitState,
                                                gait_init, gait_update,
                                                stance_contact_mask)
from quadruped_tpu_torch.robots.params import RobotParams

STANCE_KD = 3.0  # damping on stance joints (reference legCommand {0,0,0,3,tau})
# Abad compensation torque per leg, +/-0.9 N*m alternating by side.
_HIP_COMP = tuple(0.9 * (-1.0) ** ((leg + 1) % 2) if j == 0 else 0.0
                  for leg in range(4) for j in range(3))


@dataclasses.dataclass
class LocomotionConfig:
    mpc: mpc_mod.MpcConfig
    swing: swing_mod.SwingConfig
    gait: GaitConfig
    wbc: object = None
    use_wbc: bool = False
    mode: int = ControlMode.ADVANCED_TROT
    force_balance: object = None
    gait_b: GaitConfig | None = None

    def __post_init__(self):
        if self.mode != ControlMode.ADVANCED_TROT:
            raise NotImplementedError("only ADVANCED_TROT is ported")
        if self.use_wbc or self.gait_b is not None:
            raise NotImplementedError("use_wbc and gait_b are not ported")


@dataclasses.dataclass
class LocomotionState:
    gait: GaitState
    mpc: mpc_mod.MpcState
    swing: swing_mod.SwingState
    command: DesiredStateCommand
    wbc_iteration: torch.Tensor  # [B] int32
    transition: object = None


def locomotion_init(config: LocomotionConfig, params: RobotParams,
                    obs: RobotObservation,
                    cold_start: bool = True) -> LocomotionState:
    """Initial controller state for the batch of `obs`; with `cold_start`,
    one high-budget solve seeds the MPC warm start (mpc_cold_start)."""
    b = obs.base_position.shape[0]
    device = obs.base_position.device
    gait_state = gait_init(config.gait, b)
    mpc_state = mpc_mod.mpc_init(config.mpc, b, params.body_height, device)
    command = desired_state_init(b, params.body_height, device)
    if cold_start:
        mpc_state = mpc_mod.mpc_cold_start(config.mpc, params, config.gait,
                                           gait_state, mpc_state, obs,
                                           command)
    return LocomotionState(
        gait=gait_state, mpc=mpc_state,
        swing=swing_mod.swing_init(params, obs), command=command,
        wbc_iteration=torch.zeros(b, dtype=torch.int32, device=device))


def locomotion_step(config: LocomotionConfig, params: RobotParams,
                    state: LocomotionState, obs: RobotObservation,
                    cmd: TwistCommand, t: torch.Tensor,
                    v_preview: torch.Tensor | None = None,
                    z_preview: torch.Tensor | None = None):
    """One control tick. t: [B] time. Returns (HybridCommand,
    forces_world [B, 4, 3], new state)."""
    des = desired_state_update(state.command, cmd)
    gait_state = gait_update(config.gait, state.gait, t, obs.foot_contact)
    q_sw, dq_sw, swing_mask, swing_state = swing_mod.swing_step(
        config.swing, params, config.gait, gait_state, state.swing, obs, des)
    stance = stance_contact_mask(gait_state)
    stance_joint_mask = torch.repeat_interleave(stance, 3, dim=-1)

    tau_stance, forces_world, _, mpc_state = mpc_mod.mpc_step(
        config.mpc, params, config.gait, gait_state, state.mpc, obs, des,
        foot_targets_world=swing_state.foot_target_world,
        v_preview=v_preview, z_preview=z_preview)

    sw = swing_mask > 0.5
    zero = torch.zeros_like(q_sw)
    hip_comp = torch.as_tensor(_HIP_COMP, dtype=torch.float32,
                               device=q_sw.device)
    command = HybridCommand(
        q=torch.where(sw, q_sw, zero),
        kp=torch.where(sw, params.motor_kp, zero),
        dq=torch.where(sw, dq_sw, zero),
        kd=torch.where(sw, params.motor_kd, STANCE_KD * stance_joint_mask),
        tau=torch.where(sw, zero, tau_stance) + hip_comp,
    )
    new_state = LocomotionState(gait=gait_state, mpc=mpc_state,
                                swing=swing_state, command=des,
                                wbc_iteration=state.wbc_iteration + 1,
                                transition=state.transition)
    return command, forces_world, new_state
