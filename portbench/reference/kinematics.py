"""Analytic 3-DoF leg kinematics (a frozen copy of the port's twin of quadruped_tpu/robots/kinematics.py).

Frames and joint order follow the JAX module. Every function broadcasts
over leading axes; the per-leg axis is explicit ([..., 4, 3]). The
parameters are one robot or a fleet (`params.stack_params`: the leading
axis of the joint or foot tensors is then the scenario axis).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import linalg
from portbench.reference.params import (SIDE_SIGN, RobotParams,
                                               per_scenario)


def foot_position_in_hip_frame(q, l_hip, l_up, l_low) -> torch.Tensor:
    """FK: [..., 3] joint angles -> [..., 3] foot position in hip frame."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    x0 = -(l_up * s2 + l_low * s23)
    z0 = -(l_up * c2 + l_low * c23)
    y = c1 * l_hip - s1 * z0
    z = s1 * l_hip + c1 * z0
    return torch.stack([x0, y, z], dim=-1)


def foot_position_to_joint_angles(p, l_hip, l_up, l_low) -> torch.Tensor:
    """Analytic IK: [..., 3] hip-frame foot position -> [..., 3] joint angles
    (knee-backward branch; inputs outside the workspace are clamped)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d2 = x * x + y * y + z * z
    cos_knee = (d2 - l_hip * l_hip - l_up * l_up - l_low * l_low) \
        / (2 * l_up * l_low)
    cos_knee = torch.clamp(cos_knee, -1.0, 1.0)
    q_knee = -torch.acos(cos_knee)
    l_eff = torch.sqrt(torch.clamp(
        l_up * l_up + l_low * l_low + 2 * l_up * l_low * cos_knee, min=1e-9))
    theta = torch.atan2(l_low * torch.sin(q_knee),
                        l_up + l_low * torch.cos(q_knee))
    q_hip = torch.asin(torch.clamp(-x / l_eff, -1.0, 1.0)) - theta
    yz = torch.sqrt(torch.clamp(y * y + z * z - l_hip * l_hip, min=1e-9))
    q_abad = torch.atan2(z, y) + torch.atan2(yz, l_hip * torch.ones_like(yz))
    q_abad = q_abad - 2 * math.pi * torch.round(q_abad / (2 * math.pi))
    return torch.stack([q_abad, q_hip, q_knee], dim=-1)


def leg_jacobian(q, l_hip, l_up, l_low) -> torch.Tensor:
    """Analytic Jacobian d(foot pos in hip frame)/dq: [..., 3] -> [..., 3, 3]."""
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    z0 = -(l_up * c2 + l_low * c23)
    dx_dq2 = -(l_up * c2 + l_low * c23)
    dx_dq3 = -l_low * c23
    dz0_dq2 = l_up * s2 + l_low * s23
    dz0_dq3 = l_low * s23
    zero = torch.zeros_like(q1)
    return torch.stack([
        torch.stack([zero, dx_dq2, dx_dq3], dim=-1),
        torch.stack([-s1 * l_hip - c1 * z0, -s1 * dz0_dq2, -s1 * dz0_dq3],
                    dim=-1),
        torch.stack([c1 * l_hip - s1 * z0, c1 * dz0_dq2, c1 * dz0_dq3],
                    dim=-1),
    ], dim=-2)


def _leg_lengths(params: RobotParams, like: torch.Tensor, ndim: int):
    """(signed abad length [4], thigh, calf) shaped to broadcast against
    per-leg tensors [..., 4] of `ndim` dims."""
    sign = torch.as_tensor(SIDE_SIGN, dtype=like.dtype, device=like.device)
    return (sign * per_scenario(params, params.hip_length, ndim),
            per_scenario(params, params.upper_length, ndim),
            per_scenario(params, params.lower_length, ndim))


def foot_positions_in_base_frame(params: RobotParams,
                                 q: torch.Tensor) -> torch.Tensor:
    """[..., 12] joint angles -> [..., 4, 3] foot positions in base frame."""
    ql = q.reshape(q.shape[:-1] + (4, 3))
    p_hip = foot_position_in_hip_frame(ql, *_leg_lengths(params, q, q.ndim))
    return p_hip + per_scenario(params, params.hip_offset, ql.ndim)


def joint_angles_from_foot_positions(params: RobotParams,
                                     p_base: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] base-frame foot positions -> [..., 12] joint angles."""
    q = foot_position_to_joint_angles(
        p_base - per_scenario(params, params.hip_offset, p_base.ndim),
        *_leg_lengths(params, p_base, p_base.ndim - 1))
    return q.reshape(q.shape[:-2] + (12,))


def all_leg_jacobians(params: RobotParams, q: torch.Tensor) -> torch.Tensor:
    """[..., 12] joint angles -> [..., 4, 3, 3] per-leg Jacobians."""
    ql = q.reshape(q.shape[:-1] + (4, 3))
    return leg_jacobian(ql, *_leg_lengths(params, q, q.ndim))


def damped_jacobian_solve(jac: torch.Tensor, v: torch.Tensor,
                          damping: float = 1e-3) -> torch.Tensor:
    """Damped least-squares J^-1 v for [..., 3, 3] leg Jacobians, through
    the closed-form SPD inverse (core/linalg)."""
    jt = jac.transpose(-1, -2)
    m = jac @ jt + damping * torch.eye(3, dtype=jac.dtype, device=jac.device)
    return torch.einsum("...ij,...j->...i", jt,
                        torch.einsum("...ij,...j->...i", linalg.inv_spd(m), v))


def map_contact_forces_to_torques(params: RobotParams, q: torch.Tensor,
                                  forces_base: torch.Tensor) -> torch.Tensor:
    """tau = J^T f per leg: [..., 4, 3] base-frame forces -> [..., 12]."""
    j = all_leg_jacobians(params, q)
    tau = torch.einsum("...lji,...lj->...li", j, forces_base)
    return tau.reshape(tau.shape[:-2] + (12,))


