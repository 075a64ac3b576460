"""Single-rigid-body rollout simulator, batched (port of quadruped_tpu/sim/srb_sim.py).

The trunk integrates the SRB under the stance contact forces (with the
JAX module's wrench-deficit redistribution and joint-servo damping
reaction); swing joints servo toward their targets; stance feet stay
welded to their world anchors by IK. The small SPD solves go through the
closed-form `core.linalg.inv_spd`, as in the JAX module. The parameters
are one robot or a fleet (`params.stack_params`, one robot per scenario:
its own stand angles, height, mass, inertia and legs).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import (RobotParams, check_batch,
                                               per_scenario)
from quadruped_tpu_torch.utils.logging import span


@dataclasses.dataclass
class SrbSimState:
    position: torch.Tensor     # [B, 3] CoM world position
    quat: torch.Tensor         # [B, 4] body->world
    vel_world: torch.Tensor    # [B, 3]
    omega_world: torch.Tensor  # [B, 3]
    q: torch.Tensor            # [B, 12]
    dq: torch.Tensor           # [B, 12]
    foot_anchor: torch.Tensor  # [B, 4, 3] world positions of stance feet
    t: torch.Tensor            # [B] sim time


def srb_sim_init(params: RobotParams, batch: int,
                 body_height=None) -> SrbSimState:
    check_batch(params, batch)
    device = params.total_mass.device
    h = params.body_height if body_height is None else body_height
    q0 = params.stand_angles.expand(batch, 12).clone()
    foot_base = kinematics.foot_positions_in_base_frame(params, q0)
    pos = torch.zeros(batch, 3, dtype=torch.float32, device=device)
    pos[:, 2] = torch.as_tensor(h, dtype=torch.float32, device=device)
    anchors = foot_base + pos[:, None, :]
    anchors[..., 2] = 0.0
    quat = torch.zeros(batch, 4, dtype=torch.float32, device=device)
    quat[:, 0] = 1.0
    return SrbSimState(
        position=pos, quat=quat, vel_world=torch.zeros_like(pos),
        omega_world=torch.zeros_like(pos), q=q0, dq=torch.zeros_like(q0),
        foot_anchor=anchors,
        t=torch.zeros(batch, dtype=torch.float32, device=device))


def observe(params: RobotParams, state: SrbSimState,
            contact: torch.Tensor) -> RobotObservation:
    with span("qtpu.sim.observe"):
        r = se3.quat_to_rotmat(state.quat)
        return RobotObservation(
            base_position=state.position,
            base_rpy=se3.quat_to_rpy(state.quat),
            base_quat=state.quat,
            base_vel_world=state.vel_world,
            base_omega_world=state.omega_world,
            base_omega_body=torch.einsum("bj,bji->bi", state.omega_world, r),
            joint_angles=state.q,
            joint_velocities=state.dq,
            foot_contact=contact,
            foot_forces=contact * per_scenario(params, params.total_mass, 2)
            * 9.81 / 4.0,
        )


def srb_sim_step(params: RobotParams, state: SrbSimState,
                 forces_world: torch.Tensor, stance_mask: torch.Tensor,
                 q_swing_des: torch.Tensor, dq_swing_des: torch.Tensor,
                 swing_joint_mask: torch.Tensor, dt,
                 stance_kd: float = 3.0) -> SrbSimState:
    """One sim tick. forces_world [B, 4, 3], stance_mask [B, 4],
    q/dq_swing_des and swing_joint_mask [B, 12]."""
    with span("qtpu.sim.step"):
        r = se3.quat_to_rotmat(state.quat)
        b = r.shape[0]
        dtype, device = r.dtype, r.device
        stance = stance_mask[:, :, None]
        f_held = forces_world * stance

        foot_base = kinematics.foot_positions_in_base_frame(params, state.q)
        r_feet_world = torch.einsum(
            "bij,blj->bli", r,
            foot_base - per_scenario(params, params.com_offset, 3))

        # Wrench the held solution assigned to now-lifted feet, re-allocated
        # min-norm onto the current stance feet.
        f_miss = forces_world * (1.0 - stance)
        w_miss = torch.cat([
            torch.sum(f_miss, dim=1),
            torch.sum(torch.linalg.cross(r_feet_world, f_miss, dim=-1),
                      dim=1)], dim=-1)
        eye3 = torch.eye(3, dtype=dtype, device=device)
        a_map = torch.cat([eye3.expand(b, 4, 3, 3),
                           se3.skew(r_feet_world)],
                          dim=-2) * stance_mask[:, :, None, None]  # [B,4,6,3]
        aat = torch.einsum("blik,bljk->bij", a_map, a_map) \
            + 1e-2 * torch.eye(6, dtype=dtype, device=device)
        lam = torch.einsum("bij,bj->bi", linalg.inv_spd(aat), w_miss)
        delta = torch.einsum("blij,bi->blj", a_map, lam)

        # Joint-servo damping reaction of the welded stance legs.
        jac = kinematics.all_leg_jacobians(params, state.q)
        omega4 = state.omega_world[:, None, :].expand(b, 4, 3)
        v_fb = -torch.einsum(
            "bji,blj->bli", r,
            state.vel_world[:, None, :]
            + torch.linalg.cross(omega4, r_feet_world, dim=-1))
        jjt = torch.einsum("blik,bljk->blij", jac, jac) + 1e-3 * eye3
        f_damp_base = stance_kd * torch.einsum("blij,blj->bli",
                                               linalg.inv_spd(jjt), v_fb)
        f_damp = torch.einsum("bij,blj->bli", r, f_damp_base) * stance

        f = f_held + delta + f_damp

        # Trunk dynamics.
        gravity = torch.tensor([0.0, 0.0, -9.81], dtype=dtype,
                               device=device)
        acc = torch.sum(f, dim=1) \
            / per_scenario(params, params.total_mass, 2) + gravity
        torque = torch.sum(torch.linalg.cross(r_feet_world, f, dim=-1), dim=1)
        i_world = r @ params.total_inertia @ r.transpose(-1, -2)
        ang_acc = torch.einsum("bij,bj->bi", linalg.inv_spd(i_world), torque)

        vel = state.vel_world + acc * dt
        omega = state.omega_world + ang_acc * dt
        pos = state.position + vel * dt
        omega_body = torch.einsum("bj,bji->bi", omega, r)
        quat = se3.quat_integrate(state.quat, omega_body, dt)
        r_new = se3.quat_to_rotmat(quat)

        # Swing joints servo toward their targets.
        servo = min(max(dt / 0.02, 0.0), 1.0)
        q_swing = state.q + servo * (q_swing_des - state.q)

        # Stance feet welded: q from IK of the anchor in the new base frame.
        anchor = torch.where(stance > 0.5, state.foot_anchor,
                             torch.einsum("bij,blj->bli", r_new, foot_base)
                             + pos[:, None, :])
        foot_base_new = torch.einsum("bji,blj->bli", r_new,
                                     anchor - pos[:, None, :])
        q_stance = kinematics.joint_angles_from_foot_positions(params,
                                                               foot_base_new)
        foot_vel_base = -torch.einsum(
            "bji,blj->bli", r_new,
            vel[:, None, :] + torch.linalg.cross(
                omega[:, None, :].expand(b, 4, 3),
                torch.einsum("bij,blj->bli", r_new, foot_base_new), dim=-1))
        jac = kinematics.all_leg_jacobians(params, q_stance)
        dq_stance = kinematics.damped_jacobian_solve(jac, foot_vel_base)

        stance_joint = torch.repeat_interleave(stance_mask, 3, dim=-1) > 0.5
        swing_joint = swing_joint_mask > 0.5
        q_new = torch.where(stance_joint, q_stance,
                            torch.where(swing_joint, q_swing, state.q))
        dq_new = torch.where(stance_joint, dq_stance.reshape(b, 12),
                             torch.where(swing_joint, dq_swing_des,
                                         torch.zeros_like(state.dq)))
        return SrbSimState(position=pos, quat=quat, vel_world=vel,
                           omega_world=omega, q=q_new, dq=dq_new,
                           foot_anchor=anchor, t=state.t + dt)
