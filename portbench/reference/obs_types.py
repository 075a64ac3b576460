"""Observations and hybrid motor commands (a frozen copy of the port's twin of quadruped_tpu/control/types.py)."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import se3


@dataclasses.dataclass
class RobotObservation:
    """Per-tick sensor/estimator view, batch-first."""

    base_position: torch.Tensor      # [B, 3] world
    base_rpy: torch.Tensor           # [B, 3]
    base_quat: torch.Tensor          # [B, 4] (w, x, y, z)
    base_vel_world: torch.Tensor     # [B, 3]
    base_omega_world: torch.Tensor   # [B, 3]
    base_omega_body: torch.Tensor    # [B, 3]
    joint_angles: torch.Tensor       # [B, 12]
    joint_velocities: torch.Tensor   # [B, 12]
    foot_contact: torch.Tensor       # [B, 4]
    foot_forces: torch.Tensor        # [B, 4]

    @property
    def rot_body_to_world(self) -> torch.Tensor:
        return se3.quat_to_rotmat(self.base_quat)


@dataclasses.dataclass
class HybridCommand:
    """12-joint hybrid motor command {q, Kp, dq, Kd, tau}, [B, 12] each."""

    q: torch.Tensor
    kp: torch.Tensor
    dq: torch.Tensor
    kd: torch.Tensor
    tau: torch.Tensor

    def actuator_torque(self, q_meas: torch.Tensor,
                        dq_meas: torch.Tensor) -> torch.Tensor:
        """The hybrid motor law Kp (q - q_meas) + Kd (dq - dq_meas) + tau."""
        return (self.kp * (self.q - q_meas) + self.kd * (self.dq - dq_meas)
                + self.tau)
