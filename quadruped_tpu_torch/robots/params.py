"""Robot parameters (port of quadruped_tpu/robots/params.py: RobotParams, a1_params).

One `RobotParams` is one robot model, shared by every scenario of a batch:
its tensors carry no scenario axis and broadcast against the batch-first
state. Values are the JAX module's (the A1 of the reference's
a1_sim.yaml); `tests/test_torch_params.py` holds them equal field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_tpu_torch.utils import card

# Side sign of the hip (abduction) link y-offset per leg: right legs -1.
SIDE_SIGN = (-1.0, 1.0, -1.0, 1.0)
NUM_LEGS = 4
NUM_JOINTS = 12


@dataclasses.dataclass
class RobotParams:
    """Static per-robot parameters (f32 tensors, no scenario axis)."""

    total_mass: torch.Tensor        # [] kg
    total_inertia: torch.Tensor     # [3,3] body-frame rotational inertia
    body_mass: torch.Tensor         # [] trunk-only mass
    body_inertia: torch.Tensor      # [3,3]
    body_size: torch.Tensor         # [3]
    body_height: torch.Tensor       # [] nominal standing CoM height
    hip_offset: torch.Tensor        # [4,3] trunk->abad joint, body frame
    hip_length: torch.Tensor        # []
    upper_length: torch.Tensor      # []
    lower_length: torch.Tensor      # []
    default_hip_position: torch.Tensor  # [4,3]
    com_offset: torch.Tensor        # [3]
    links_mass: torch.Tensor        # [3]
    links_inertia: torch.Tensor     # [3,3,3]
    links_com_pos: torch.Tensor     # [3,3]
    motor_kp: torch.Tensor          # [12]
    motor_kd: torch.Tensor          # [12]
    torque_limit: torch.Tensor      # []
    stand_angles: torch.Tensor      # [12]
    standup_angles: torch.Tensor    # [12]
    sitdown_angles: torch.Tensor    # [12]
    friction_coef: torch.Tensor     # [] ground mu used by the MPC

    @property
    def signed_hip_length(self) -> torch.Tensor:
        """[4] abad link y-offset with per-leg side sign."""
        return self.hip_length * torch.as_tensor(
            SIDE_SIGN, dtype=torch.float32, device=self.hip_length.device)

    @property
    def max_force(self) -> torch.Tensor:
        """Per-leg vertical force cap fMax = m*g (reference convention)."""
        return self.total_mass * 9.81


def a1_params(device=None) -> RobotParams:
    """Unitree A1 (reference: quadruped/config/a1_sim/a1_sim.yaml), on the
    card unless `device` says otherwise."""
    device = card.resolve(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def tile4(leg):
        return f(np.tile(np.asarray(leg, np.float32), 4))

    return RobotParams(
        total_mass=f(13.0),
        total_inertia=f(np.diag([0.24, 0.80, 1.0])),
        body_mass=f(6.0),
        body_inertia=f(np.reshape(
            [0.015853, 0, 0, 0, 0.037799, 0, 0, 0, 0.045654], (3, 3))),
        body_size=f([0.267, 0.194, 0.114]),
        body_height=f(0.28),
        hip_offset=f([[0.1805, -0.047, 0.0], [0.1805, 0.047, 0.0],
                      [-0.1805, -0.047, 0.0], [-0.1805, 0.047, 0.0]]),
        hip_length=f(0.08505),
        upper_length=f(0.2),
        lower_length=f(0.2),
        default_hip_position=f([[0.185, -0.135, 0], [0.185, 0.135, 0],
                                [-0.185, -0.135, 0], [-0.185, 0.135, 0]]),
        com_offset=f([0.005, 0.00145, 0.000515]),
        links_mass=f([0.696, 1.013, 0.166]),
        links_inertia=f(np.reshape([
            0.000469246, -9.409e-06, -3.42e-07,
            -9.409e-06, 0.00080749, -4.66e-07,
            -3.42e-07, -4.66e-07, 0.000552929,
            0.005529065, 4.825e-06, 0.000343869,
            4.825e-06, 0.005139339, 2.2448e-05,
            0.000343869, 2.2448e-05, 0.001367788,
            0.002997972, 0.0, -0.000141163,
            0.0, 0.003014022, 0.0,
            -0.000141163, 0.0, 3.2426e-05], (3, 3, 3))),
        links_com_pos=f([[-0.0033, 0, 0],
                         [-0.003237, -0.022327, -0.027326],
                         [0.006435, 0, -0.107]]),
        motor_kp=tile4((100.0, 100.0, 100.0)),
        motor_kd=tile4((1.0, 2.0, 2.0)),
        torque_limit=f(23.0),
        stand_angles=tile4((0.0, 0.67, -1.25)),
        standup_angles=tile4((0.0, 0.9, -1.8)),
        sitdown_angles=tile4((-0.167136, 0.934969, -2.54468)),
        friction_coef=f(0.45),
    )
