"""Open-loop maneuvers: stand up, sit down, keep standing, foot control
(port of quadruped_tpu/control/actions.py).

Phase-parameterized command generators that the FSM evaluates per tick: a
smoothstep blend from the pose captured on entry to the target pose.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_tpu_torch.control.types import HybridCommand
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams

STANDUP_DURATION = 3.0   # s
SITDOWN_DURATION = 3.0
# XLA folds the JAX module's division by the duration into a product with
# the float32 reciprocal; so does the port.
_INV_STANDUP = float(np.float32(1.0) / np.float32(STANDUP_DURATION))
_INV_SITDOWN = float(np.float32(1.0) / np.float32(SITDOWN_DURATION))


def _hold(params: RobotParams, q: torch.Tensor) -> HybridCommand:
    zero = torch.zeros_like(q)
    return HybridCommand(q=q, kp=params.motor_kp.expand_as(q), dq=zero,
                         kd=params.motor_kd.expand_as(q), tau=zero.clone())


def _blend_command(params: RobotParams, q_start: torch.Tensor,
                   q_target: torch.Tensor, phase) -> HybridCommand:
    """q_start [B, 12] -> q_target [12] at phase [B] (smoothstep)."""
    s = torch.clamp(phase, 0.0, 1.0)
    s = s * s * (3.0 - 2.0 * s)
    return _hold(params, q_start + (q_target - q_start) * s[:, None])


def standup_command(params: RobotParams, q_start: torch.Tensor,
                    t_since_start: torch.Tensor) -> HybridCommand:
    """Stand up: blend from the captured pose to the stand-up angles."""
    return _blend_command(params, q_start, params.standup_angles,
                          t_since_start * _INV_STANDUP)


def sitdown_command(params: RobotParams, q_start: torch.Tensor,
                    t_since_start: torch.Tensor) -> HybridCommand:
    """Sit down to the folded pose."""
    return _blend_command(params, q_start, params.sitdown_angles,
                          t_since_start * _INV_SITDOWN)


def keep_stand_command(params: RobotParams, batch: int) -> HybridCommand:
    """Hold the nominal stand pose, for `batch` scenarios."""
    return _hold(params, params.stand_angles.expand(batch, 12).clone())


def control_foot_command(params: RobotParams,
                         foot_targets_base: torch.Tensor) -> HybridCommand:
    """Drive the feet [B, 4, 3] to base-frame targets by IK."""
    return _hold(params, kinematics.joint_angles_from_foot_positions(
        params, foot_targets_base))
