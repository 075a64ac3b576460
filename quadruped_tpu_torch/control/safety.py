"""Safety checks: orientation guard, tip-over envelope and torque clip,
batched (port of quadruped_tpu/control/safety.py)."""

from __future__ import annotations

import torch

from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.robots.params import RobotParams

MAX_ROLL_PITCH = 0.5     # rad
HEIGHT_RANGE = (0.08, 0.45)


def check_safe_orientation(obs: RobotObservation) -> torch.Tensor:
    """[B] 1.0 where |roll| and |pitch| are within limits."""
    rpy = obs.base_rpy
    ok = (torch.abs(rpy[..., 0]) < MAX_ROLL_PITCH) \
        & (torch.abs(rpy[..., 1]) < MAX_ROLL_PITCH)
    return ok.to(torch.float32)


def check_tip_over(obs: RobotObservation) -> torch.Tensor:
    """[B] 1.0 where the base is inside the height envelope and finite."""
    z = obs.base_position[..., 2]
    ok = (z > HEIGHT_RANGE[0]) & (z < HEIGHT_RANGE[1]) & torch.isfinite(z)
    return ok.to(torch.float32)


def clip_command(params: RobotParams, command: HybridCommand) -> HybridCommand:
    """Clip the feed-forward torque to the robot's limit."""
    return HybridCommand(q=command.q, kp=command.kp, dq=command.dq,
                         kd=command.kd, tau=torch.clamp(
                             command.tau, -params.torque_limit,
                             params.torque_limit))


def damped(command: HybridCommand) -> HybridCommand:
    """Pure joint damping (kd = 2), the command of an unsafe scenario."""
    zero = torch.zeros_like(command.q)
    return HybridCommand(q=zero, kp=zero, dq=zero,
                         kd=torch.full_like(command.kd, 2.0), tau=zero)


def pick(mask: torch.Tensor, a: HybridCommand,
         b: HybridCommand) -> HybridCommand:
    """Per scenario, a where mask [B] else b."""
    m = mask[:, None]
    return HybridCommand(q=torch.where(m, a.q, b.q),
                         kp=torch.where(m, a.kp, b.kp),
                         dq=torch.where(m, a.dq, b.dq),
                         kd=torch.where(m, a.kd, b.kd),
                         tau=torch.where(m, a.tau, b.tau))


def safe_command(params: RobotParams, obs: RobotObservation,
                 command: HybridCommand) -> tuple[HybridCommand, torch.Tensor]:
    """Clip torques and damp every scenario whose orientation or height is
    unsafe. Returns (command', safe mask [B])."""
    safe = check_safe_orientation(obs) * check_tip_over(obs)
    cmd = clip_command(params, command)
    return pick(safe > 0.5, cmd, damped(cmd)), safe
