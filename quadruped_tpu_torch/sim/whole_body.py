"""Whole-body batched simulator: 18-DoF dynamics, penalty contact and the motor law (port of quadruped_tpu/sim/whole_body.py).

One sim tick, in `substeps` physics steps:

  1. the hybrid motor law tau = Kp (q_des - q) + Kd (dq_des - dq) + tau_ff,
     with the joint-velocity clip on the command and the torque clip;
  2. contact forces at the 4 feet: Hunt-Crossley normal force
     f = k d (1 + 1.5 alpha d_dot) and regularized Coulomb friction;
  3. forward dynamics of the 13-body model
     (dynamics/floating_base.forward_dynamics) under the joint torques and
     world-frame foot forces;
  4. semi-implicit Euler integration of the floating-base state.

Batch-first: the state carries the leading scenario axis. Terrain is a
height function (sim/terrain.py); the default is flat ground at z = 0.
The robot is one model or a fleet (`params.stack_params` with the model
`build_model` gives for it: its own stand angles, height and torque
limit per scenario).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.dynamics.floating_base import FbState
from quadruped_tpu_torch.robots.params import (RobotParams, check_batch,
                                               per_scenario)


@dataclasses.dataclass
class ContactModel:
    """Penalty contact and actuator limits. Each field is a number shared
    by the batch or a [B] tensor, one value per scenario."""

    k_normal: object = 8000.0       # N/m
    # Hunt-Crossley damping coefficient alpha (s/m): the damping vanishes
    # at zero depth, and an impact at speed v restitutes e ~ 1 - alpha v.
    hc_alpha: object = 0.5          # s/m
    mu: object = 0.6
    v_slip: object = 0.05           # friction regularization, m/s
    joint_vel_limit: object = 21.0  # rad/s


@dataclasses.dataclass
class WholeBodySimState:
    fb: FbState
    t: torch.Tensor  # [B]


def _per_scenario(value, like: torch.Tensor) -> torch.Tensor:
    """A ContactModel field as a tensor on like's device that broadcasts
    against the [B, ...] tensor `like`."""
    p = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if p.ndim:
        p = p.reshape(p.shape + (1,) * (like.ndim - p.ndim))
    return p


def _rotate(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bij,bj->bi", r, v)


def whole_body_init(params: RobotParams, batch: int,
                    body_height=None) -> WholeBodySimState:
    """B robots standing at their stand angles, base at `body_height` (a
    number or a [B] tensor; params.body_height by default), on params'
    device. Raises ValueError when stacked `params` hold another number of
    robots than `batch`."""
    check_batch(params, batch)
    device = params.total_mass.device
    h = params.body_height if body_height is None else body_height
    position = torch.zeros(batch, 3, dtype=torch.float32, device=device)
    position[:, 2] = torch.as_tensor(h, dtype=torch.float32, device=device)
    quat = torch.zeros(batch, 4, dtype=torch.float32, device=device)
    quat[:, 0] = 1.0
    q = params.stand_angles.expand(batch, 12).clone()
    state = FbState(quat=quat, position=position,
                    omega_body=torch.zeros_like(position),
                    vel_body=torch.zeros_like(position), q=q,
                    dq=torch.zeros_like(q))
    return WholeBodySimState(fb=state, t=torch.zeros(
        batch, dtype=torch.float32, device=device))


def contact_forces(model: fb.FloatingBaseModel, state: FbState,
                   contact: ContactModel,
                   terrain_height: Callable | None = None):
    """([B, 4, 3] world-frame contact forces, [B, 4] contact flags,
    [B, 4, 3] foot positions)."""
    jc, _, p_feet = fb.contact_jacobians(model, state)
    vgen = torch.cat([state.omega_body, state.vel_body, state.dq], dim=-1)
    v_feet = torch.einsum("blij,bj->bli", jc, vgen)

    ground_z = (torch.zeros_like(p_feet[..., 2]) if terrain_height is None
                else terrain_height(p_feet[..., 0], p_feet[..., 1]))
    depth = ground_z - p_feet[..., 2]
    in_contact = depth > 0.0

    # Hunt-Crossley normal force, penetration rate d_dot = -vz; clamped at
    # zero on separation.
    ddot = -torch.clamp(v_feet[..., 2], -10.0, 10.0)
    k = _per_scenario(contact.k_normal, depth)
    alpha = _per_scenario(contact.hc_alpha, depth)
    fz = torch.where(in_contact, k * depth * (1.0 + 1.5 * alpha * ddot),
                     torch.zeros_like(depth))
    fz = torch.clamp(fz, min=0.0)

    # Regularized Coulomb friction: -mu fz v_t / max(|v_t|, v_slip).
    v_t = v_feet[..., :2]
    v_norm = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
    scale = torch.clamp(v_norm / _per_scenario(contact.v_slip, v_norm),
                        max=1.0)
    dir_t = v_t / torch.clamp(v_norm, min=1e-6)
    f_t = -_per_scenario(contact.mu, v_norm) * fz[..., None] * scale * dir_t
    forces = torch.cat([f_t, fz[..., None]], dim=-1)
    return forces, in_contact.to(torch.float32), p_feet


def whole_body_step(params: RobotParams, model: fb.FloatingBaseModel,
                    state: WholeBodySimState, command: HybridCommand,
                    contact: ContactModel, dt,
                    terrain_height: Callable | None = None,
                    substeps: int = 2):
    """One control period in `substeps` physics steps. Returns (new state,
    [B, 4] foot contact flags of the last substep)."""
    s = state.fb
    flags = torch.ones_like(s.q[..., :4])
    h = dt / substeps
    for _ in range(substeps):
        limit = _per_scenario(contact.joint_vel_limit, command.dq)
        dq_cmd = torch.clamp(command.dq, -limit, limit)
        tau_motor = dataclasses.replace(command, dq=dq_cmd).actuator_torque(
            s.q, s.dq)
        limit = per_scenario(params, params.torque_limit, 2)
        tau_motor = torch.clamp(tau_motor, -limit, limit)
        tau_gen = torch.cat([torch.zeros_like(tau_motor[..., :6]),
                             tau_motor], dim=-1)

        f_feet, flags, _ = contact_forces(model, s, contact, terrain_height)
        qdd = fb.forward_dynamics(model, s, tau_gen, f_feet)

        omega = s.omega_body + qdd[..., 0:3] * h
        vel = s.vel_body + qdd[..., 3:6] * h
        dq = s.dq + qdd[..., 6:] * h
        quat = se3.quat_integrate(s.quat, omega, h)
        r = se3.quat_to_rotmat(s.quat)
        pos = s.position + _rotate(r, vel) * h
        s = FbState(quat=quat, position=pos, omega_body=omega, vel_body=vel,
                    q=s.q + dq * h, dq=dq)
    return WholeBodySimState(fb=s, t=state.t + dt), flags


def observe(params: RobotParams, model: fb.FloatingBaseModel,
            state: WholeBodySimState, contact: ContactModel,
            terrain_height: Callable | None = None) -> RobotObservation:
    """Ground-truth observation of the whole-body state."""
    s = state.fb
    r = se3.quat_to_rotmat(s.quat)
    forces, flags, _ = contact_forces(model, s, contact, terrain_height)
    return RobotObservation(
        base_position=s.position,
        base_rpy=se3.quat_to_rpy(s.quat),
        base_quat=s.quat,
        base_vel_world=_rotate(r, s.vel_body),
        base_omega_world=_rotate(r, s.omega_body),
        base_omega_body=s.omega_body,
        joint_angles=s.q,
        joint_velocities=s.dq,
        foot_contact=flags,
        foot_forces=forces[..., 2])
