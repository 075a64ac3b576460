"""Force-balance ("virtual model") stance controller, batched (port of quadruped_tpu/control/stance_force_balance.py).

The stance controller of the VELOCITY and POSITION locomotion modes:

  * desired 6-D CoM acceleration from PD on pose and twist error, clipped;
  * the 6x12 "mass matrix" [1/M ...; I^-1 [r]x ...] with the trunk inertia
    rotated to world;
  * QP: min ||M F - (a_des + g)||^2_Q + reg F^T (ones + I) F subject to
    per-leg normal-force bounds and a 4-edge friction pyramid, solved to its
    exact minimizer by the whitened ADMM + active-set polish of
    solvers/polish.py.

World-frame formulation; every tensor carries the leading scenario axis,
and the robot is one model or a fleet (`params.stack_params`: its own
mass, inertia, CoM offset, friction coefficient and torque limit per
scenario).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quadruped_tpu_torch.control.desired_state import DesiredStateCommand
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams, per_scenario
from quadruped_tpu_torch.solvers import polish, qp

BIG = 1e8


@dataclasses.dataclass
class ForceBalanceConfig:
    """Gains from the reference's stance_leg_controller.yaml (velocity
    mode)."""

    kp: tuple = (100., 100., 100., 200., 200., 0.)
    kd: tuple = (20., 20., 10., 20., 20., 25.)
    max_ddq: tuple = (10., 10., 10., 20., 20., 20.)
    acc_weight: tuple = (1., 1., 1., 10., 10., 1.)
    reg_weight: float = 1e-4
    # Whitened-ADMM budget and active-set polish passes (solvers/polish.py);
    # 64 is the JAX package's golden-gated default.
    qp_iters: int = 64
    polish_passes: int = 24
    # Warm-start the QP from the previous tick's forces (the walk path);
    # the VELOCITY and POSITION modes solve cold every tick.
    warm_start: bool = False
    # Servo x/y position error too (WALK mode); velocity mode tracks
    # velocity, height and orientation only.
    track_xy: bool = False


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def desired_acceleration(config: ForceBalanceConfig, obs: RobotObservation,
                         des: DesiredStateCommand) -> torch.Tensor:
    """[B, 6] desired CoM acceleration [lin(3); ang(3)] in world frame."""
    r_mat = obs.rot_body_to_world
    if config.track_xy:
        pos_err = des.position - obs.base_position
    else:
        zero = torch.zeros_like(obs.base_position[:, 2])
        pos_err = torch.stack([zero, zero, des.position[:, 2]
                               - obs.base_position[:, 2]], dim=-1)
    rpy_des = torch.cat([des.rpy[:, :2], obs.base_rpy[:, 2:]], dim=-1)
    ori_err = se3.quat_error_so3(se3.rpy_to_quat(rpy_des), obs.base_quat)
    ori_err_world = qp.mv(r_mat, ori_err)

    vel_err = qp.mv(r_mat, des.velocity) - obs.base_vel_world
    omega_err = qp.mv(r_mat, des.omega) - obs.base_omega_world

    pose_err = torch.cat([pos_err, ori_err_world], dim=-1)
    twist_err = torch.cat([vel_err, omega_err], dim=-1)
    ddq = _vec(config.kp, r_mat) * pose_err + _vec(config.kd, r_mat) \
        * twist_err
    max_ddq = _vec(config.max_ddq, r_mat)
    return torch.clamp(ddq, -max_ddq, max_ddq)


def mass_matrix(params: RobotParams, r_feet_world: torch.Tensor,
                r_mat: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 6, 12] wrench-per-force map; with r_mat the trunk inertia is
    rotated to world (I_w = R I R^T), without it the base-frame variant."""
    inv_mass = torch.eye(3, dtype=r_feet_world.dtype,
                         device=r_feet_world.device) \
        / per_scenario(params, params.total_mass, 3)
    inertia = params.total_inertia
    if r_mat is not None:
        inertia = r_mat @ inertia @ r_mat.transpose(-1, -2)
    inv_inertia = linalg.inv_spd(inertia)
    skews = se3.skew(r_feet_world)                        # [B, 4, 3, 3]
    ang = torch.einsum("...ij,...ljk->...lik", inv_inertia, skews)
    batch = r_feet_world.shape[:-2]
    top = torch.cat([inv_mass] * 4, dim=-1).expand(batch + (3, 12))
    bottom = torch.cat(ang.unbind(-3), dim=-1)            # [B, 3, 12]
    return torch.cat([top, bottom], dim=-2)


def build_constraints(params: RobotParams, contacts: torch.Tensor,
                      f_min_ratio: torch.Tensor, f_max_ratio: torch.Tensor,
                      surface_normal: torch.Tensor):
    """OSQP-form (A [..., 20, 12], l, u): per leg the normal-force bounds and
    the four friction-pyramid rows (>= 0)."""
    dtype, device = surface_normal.dtype, surface_normal.device
    mu = per_scenario(params, params.friction_coef, 2)
    weight = per_scenario(params, params.total_mass, 2) * 9.8
    if params.stacked:
        surface_normal = surface_normal.expand(mu.shape[:1] + (3,))
    # Orthonormal tangent basis on the surface for any normal.
    x_axis = torch.as_tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)
    t2 = torch.linalg.cross(surface_normal,
                            x_axis.expand_as(surface_normal), dim=-1)
    t2 = t2 / torch.clamp(torch.linalg.vector_norm(t2, dim=-1, keepdim=True),
                          min=1e-6)
    t1 = torch.linalg.cross(t2, surface_normal, dim=-1)
    tangent1 = t1 / torch.clamp(
        torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-6)
    tangent2 = t2
    block = torch.stack([surface_normal,
                         mu * surface_normal + tangent1,
                         mu * surface_normal - tangent1,
                         mu * surface_normal + tangent2,
                         mu * surface_normal - tangent2], dim=-2)  # [..., 5, 3]
    # Block diagonal over the legs: a[l, r, m, k] = block[r, k] (l == m).
    eye4 = torch.eye(4, dtype=dtype, device=device)
    a = torch.einsum("lm,...rk->...lrmk", eye4, block)
    a = a.reshape(a.shape[:-4] + (20, 12))

    f_min = f_min_ratio * weight * contacts
    f_max = torch.where(contacts > 0.5, f_max_ratio * weight,
                        torch.zeros_like(contacts))
    zero = torch.zeros_like(f_min)
    big = torch.full_like(f_max, BIG)
    l = torch.stack([f_min] + [zero] * 4, dim=-1)
    u = torch.stack([f_max] + [big] * 4, dim=-1)
    a = a.expand(l.shape[:-2] + (20, 12))
    return a, l.reshape(l.shape[:-2] + (20,)), u.reshape(u.shape[:-2] + (20,))


def compute_contact_forces(config: ForceBalanceConfig, params: RobotParams,
                           obs: RobotObservation, des: DesiredStateCommand,
                           contacts: torch.Tensor, f_min_ratio=None,
                           f_max_ratio=None, surface_normal=None,
                           x_warm: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """[B, 4, 3] world-frame contact forces. contacts [B, 4]; f_min_ratio
    and f_max_ratio [4] or [B, 4] (defaults 0.01 and 10); surface_normal [3]
    or [B, 3] (default +z); x_warm: optional [B, 4, 3] previous-tick
    forces that warm-start the QP."""
    dtype, device = obs.base_position.dtype, obs.base_position.device
    if f_min_ratio is None:
        f_min_ratio = torch.full((4,), 0.01, dtype=dtype, device=device)
    if f_max_ratio is None:
        f_max_ratio = torch.full((4,), 10.0, dtype=dtype, device=device)
    if surface_normal is None:
        surface_normal = torch.as_tensor([0.0, 0.0, 1.0], dtype=dtype,
                                         device=device)

    r_mat = obs.rot_body_to_world
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    r_feet = torch.einsum(
        "bij,blj->bli", r_mat,
        foot_base - per_scenario(params, params.com_offset, 3))

    m6 = mass_matrix(params, r_feet, r_mat)
    a_des = desired_acceleration(config, obs, des)
    g_vec = torch.as_tensor([0.0, 0.0, 9.8, 0.0, 0.0, 0.0], dtype=dtype,
                            device=device)
    target = a_des + g_vec

    # Effective objective 1/2||MF - target||^2_Q + reg/2 F^T(ones + I)F:
    # the reference adds regWeight * an ALL-ONES matrix (ComputeObjective-
    # Matrix) and then 1e-4 I. The ones term decides the per-leg split along
    # the near-nullspace (kappa(P) ~ 1e8), so parity needs it reproduced
    # exactly and the exact minimizer: P = C^T C + reg I with
    # C = [Q^1/2 M ; sqrt(reg) 1^T], solved by solvers/polish.py.
    q_diag = _vec(config.acc_weight, m6)
    qvec = -torch.einsum("bki,bk->bi", m6, q_diag * target)
    ones = torch.full(m6.shape[:-2] + (1, 12), math.sqrt(config.reg_weight),
                      dtype=dtype, device=device)
    c_factor = torch.cat([torch.sqrt(q_diag)[:, None] * m6, ones], dim=-2)

    a, l, u = build_constraints(params, contacts, f_min_ratio, f_max_ratio,
                                surface_normal)
    prob = polish.FactoredQP(c=c_factor, reg=config.reg_weight, q=qvec,
                             a=a, l=l, u=u)
    x = polish.solve_factored(
        prob, admm_iters=config.qp_iters, polish_passes=config.polish_passes,
        x0=None if x_warm is None else x_warm.reshape(x_warm.shape[:-2]
                                                      + (12,)))
    return x.reshape(x.shape[:-1] + (4, 3))


def stance_torques(params: RobotParams, obs: RobotObservation,
                   forces_world: torch.Tensor,
                   contacts: torch.Tensor) -> torch.Tensor:
    """[B, 12] tau = J^T (-R^T F) on contact legs."""
    r_mat = obs.rot_body_to_world
    f_base = torch.einsum("bji,blj->bli", r_mat, forces_world)
    tau = kinematics.map_contact_forces_to_torques(params, obs.joint_angles,
                                                   -f_base)
    limit = per_scenario(params, params.torque_limit, 2)
    tau = torch.clamp(tau, -limit, limit)
    return tau * torch.repeat_interleave(contacts, 3, dim=-1)
