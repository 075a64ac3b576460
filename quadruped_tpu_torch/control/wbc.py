"""Whole-body controller: task hierarchy and floating-base inverse-dynamics QP, batched (port of quadruped_tpu/control/wbc.py).

* Tasks [body orientation, body position, swing foot x 4] and the contact
  list from the floating-base model (`build_tasks`).
* The kinematic null-space cascade with damped pseudo-inverses
  (`multitask_projection`) -> joint position and velocity commands.
* The dynamic pass (`wbic_torque`): the dynamics-consistent weighted
  pseudo-inverse cascade for the acceleration command, then a QP over
  [delta qdd_fb (6), delta F_r (12)] with the floating-base dynamics as
  equality rows and per-contact friction pyramids (mu 0.4, fz <= m g),
  solved by `solvers/qp.py::admm_solve` -> feed-forward torques.

Static shapes with masks: all four contacts and foot tasks are always
present. Swing legs get zeroed contact rows and delta F pinned to 0,
stance legs zeroed foot-task rows; a zero row has an exactly zero column
in the damped pseudo-inverse. Every tensor carries the leading scenario
axis, and the stance/swing choices are per-scenario masks. The robot is
one model or a fleet (`params.stack_params` with the model
`build_model` gives for it: its own force cap m g and torque limit per
scenario).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.robots.params import RobotParams, per_scenario
from quadruped_tpu_torch.solvers import qp
from quadruped_tpu_torch.utils.logging import span

NDOF = fb.NUM_DOF  # 18
PINV_THRESH = 1e-3
BIG = 1e8


@dataclasses.dataclass
class WbcConfig:
    """Gains of the reference's WBC locomotion controller; each gain is 3
    numbers or a [3] tensor."""

    kp_ori: object = (100.0, 100.0, 100.0)
    kd_ori: object = (10.0, 10.0, 10.0)
    kp_pos: object = (100.0, 100.0, 100.0)
    kd_pos: object = (10.0, 10.0, 10.0)
    kp_foot: object = (500.0, 500.0, 500.0)
    kd_foot: object = (10.0, 10.0, 10.0)
    weight_fb: float = 0.1
    weight_fr: float = 1.0
    friction_mu: float = 0.4
    qp_iters: int = 50


@dataclasses.dataclass
class WbcCommand:
    """The reference's WBC control data, batch-first."""

    p_body_des: torch.Tensor        # [B, 3] world
    v_body_des: torch.Tensor        # [B, 3] world
    a_body_des: torch.Tensor        # [B, 3] world
    rpy_des: torch.Tensor           # [B, 3]
    omega_des_world: torch.Tensor   # [B, 3]
    p_foot_des: torch.Tensor        # [B, 4, 3] world
    v_foot_des: torch.Tensor        # [B, 4, 3] world
    a_foot_des: torch.Tensor        # [B, 4, 3] world
    fr_des: torch.Tensor            # [B, 4, 3] MPC reaction forces, world
    contact_state: torch.Tensor     # [B, 4] 1.0 = stance


def _gain(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, r, c] @ [B, c] as a batched matrix product."""
    return (m @ v[..., None])[..., 0]


def _eye(like: torch.Tensor, n: int = NDOF) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _pinv(j: torch.Tensor, rcond: float = PINV_THRESH) -> torch.Tensor:
    """Damped right pseudo-inverse of a wide task Jacobian (the JAX
    module's stand-in for the reference's thresholded SVD
    pseudo-inverse); all-zero rows give exactly zero columns."""
    return linalg.damped_pinv(j, rcond)


def _weighted_pinv(j: torch.Tensor, a_inv: torch.Tensor,
                   rcond: float = 1e-4) -> torch.Tensor:
    """Dynamics-consistent inverse A^-1 J^T (J A^-1 J^T + rcond I)^-1."""
    temp = linalg.matmul_small(a_inv, j.transpose(-1, -2))
    lam = linalg.matmul_small(j, temp)
    lam_inv = linalg.inv_spd(lam + rcond * _eye(j, lam.shape[-1]))
    return linalg.matmul_small(temp, lam_inv)


def _null_projector(j: torch.Tensor) -> torch.Tensor:
    """N = I - J^+ J."""
    return _eye(j) - linalg.matmul_small(_pinv(j), j)


def _rows3(block: torch.Tensor, col: int) -> torch.Tensor:
    """[B, 3, 3] -> [B, 3, 18] with the block in columns col..col+2."""
    b = block.shape[0]
    zeros = block.new_zeros(b, 3, NDOF - 3)
    return torch.cat([zeros[..., :col], block, zeros[..., col:]], dim=-1)


def build_tasks(config: WbcConfig, model: fb.FloatingBaseModel,
                state: fb.FbState, cmd: WbcCommand):
    """Tasks [ori, pos, foot0..3] stacked on dim 1: (Jt [B, 6, 3, 18],
    JtDotQdot [B, 6, 3], pos_err, vel_des, xddot_cmd [B, 6, 3]), swing-
    masked foot tasks, then (jc, jcdqd, p_feet) of the contacts."""
    r = se3.quat_to_rotmat(state.quat)
    jc, jcdqd, p_feet = fb.contact_jacobians(model, state)
    vgen = torch.cat([state.omega_body, state.vel_body, state.dq], dim=-1)
    v_feet = torch.einsum("blij,bj->bli", jc, vgen)
    zeros3 = torch.zeros_like(state.position)

    # Body orientation (error in the world frame).
    q_des = se3.rpy_to_quat(cmd.rpy_des)
    err_ori = se3.quat_rotate(q_des, se3.quat_error_so3(q_des, state.quat))
    w_world = _mv(r, state.omega_body)
    acc_ori = torch.clamp(_gain(config.kp_ori, r) * err_ori
                          + _gain(config.kd_ori, r)
                          * (cmd.omega_des_world - w_world), -10, 10)

    # Body position.
    err_pos = cmd.p_body_des - state.position
    v_world = _mv(r, state.vel_body)
    acc_pos = torch.clamp(_gain(config.kp_pos, r) * err_pos
                          + _gain(config.kd_pos, r)
                          * (cmd.v_body_des - v_world) + cmd.a_body_des,
                          -10, 10)

    # Swing-foot positions, stance-masked.
    swing = (1.0 - cmd.contact_state)[..., None]              # [B, 4, 1]
    foot_err = cmd.p_foot_des - p_feet
    foot_acc = (_gain(config.kp_foot, r) * foot_err
                + _gain(config.kd_foot, r) * (cmd.v_foot_des - v_feet)
                + cmd.a_foot_des) * swing

    jts = torch.cat([torch.stack([_rows3(r, 0), _rows3(r, 3)], dim=1),
                     jc * swing[..., None]], dim=1)
    jdqds = torch.cat([torch.stack([zeros3, zeros3], dim=1),
                       jcdqd * swing], dim=1)
    errs = torch.cat([torch.stack([err_ori, err_pos], dim=1),
                      foot_err * swing], dim=1)
    vels = torch.cat([torch.stack([cmd.omega_des_world, cmd.v_body_des],
                                  dim=1), cmd.v_foot_des * swing], dim=1)
    accs = torch.cat([torch.stack([acc_ori, acc_pos], dim=1), foot_acc],
                     dim=1)
    return jts, jdqds, errs, vels, accs, jc, jcdqd, p_feet


def multitask_projection(jts, errs, vels, jc_stacked):
    """Kinematic null-space cascade -> (delta_q [B, 18], qdot [B, 18])."""
    n_pre = _null_projector(jc_stacked)
    jt0 = jts[:, 0] @ n_pre
    jt0_pinv = _pinv(jt0)
    delta_q = _mv(jt0_pinv, errs[:, 0])
    qdot = _mv(jt0_pinv, vels[:, 0])
    n_pre_next = n_pre @ _null_projector(jt0)
    n_tasks = jts.shape[1]
    for i in range(1, n_tasks):
        jt = jts[:, i]
        jt_pre = jt @ n_pre_next
        jt_pinv = _pinv(jt_pre)
        delta_q = delta_q + _mv(jt_pinv, errs[:, i] - _mv(jt, delta_q))
        qdot = qdot + _mv(jt_pinv, vels[:, i] - _mv(jt, qdot))
        if i < n_tasks - 1:
            n_pre_next = n_pre_next @ _null_projector(jt_pre)
    return delta_q, qdot


def _uf_rows(mu: float, like: torch.Tensor) -> torch.Tensor:
    """[6, 3] friction-pyramid rows of one contact on (fx, fy, fz)."""
    return torch.as_tensor([[0.0, 0.0, 1.0], [1.0, 0.0, mu], [-1.0, 0.0, mu],
                            [0.0, 1.0, mu], [0.0, -1.0, mu],
                            [0.0, 0.0, -1.0]], dtype=like.dtype,
                           device=like.device)


def wbic_torque(config: WbcConfig, params: RobotParams,
                model: fb.FloatingBaseModel, state: fb.FbState,
                cmd: WbcCommand, jts, jdqds, accs, jc, jcdqd):
    """Dynamic pass: acceleration cascade and QP -> (feed-forward torque
    [B, 12], qddot [B, 18], total reaction forces [B, 12])."""
    with span("qtpu.wbc.dynamics"):
        b = state.q.shape[0]
        a_mat = fb.mass_matrix(model, state.q)
        grav = fb.gravity_force(model, state)
        cori = fb.coriolis_force(model, state)
        a_inv = linalg.inv_spd(a_mat)
        eye = _eye(a_mat)

        contact = cmd.contact_state
        cmask = torch.repeat_interleave(contact, 3, dim=-1)    # [B, 12]
        jc_stacked = jc.reshape(b, 12, NDOF) * cmask[..., None]
        jc_t = jc_stacked.transpose(-1, -2)
        jcdqd_stacked = jcdqd.reshape(b, 12) * cmask
        fr_des = cmd.fr_des.reshape(b, 12) * cmask

        # Acceleration cascade with dynamics-consistent inverses.
        jc_bar = _weighted_pinv(jc_stacked, a_inv)
        qddot_pre = _mv(jc_bar, -jcdqd_stacked)
        n_pre = eye - jc_bar @ jc_stacked
        n_tasks = jts.shape[1]
        for i in range(n_tasks):
            jt = jts[:, i]
            jt_pre = jt @ n_pre
            jt_bar = _weighted_pinv(jt_pre, a_inv)
            qddot_pre = qddot_pre + _mv(
                jt_bar, accs[:, i] - jdqds[:, i] - _mv(jt, qddot_pre))
            if i < n_tasks - 1:
                n_pre = n_pre @ (eye - jt_bar @ jt_pre)

        # QP over z = [dqdd_fb (6), dFr (12)].
        nz = 18
        weights = torch.cat([
            torch.full((6,), config.weight_fb, dtype=a_mat.dtype,
                       device=a_mat.device),
            torch.full((12,), config.weight_fr, dtype=a_mat.dtype,
                       device=a_mat.device)])
        p_cost = torch.diag(weights).expand(b, nz, nz)
        q_cost = a_mat.new_zeros(b, nz)

        # Equality rows: the floating-base dynamics.
        a_eq = torch.cat([a_mat[:, 0:6, 0:6], -jc_t[:, 0:6, :]], dim=-1)
        rhs_eq = -(_mv(a_mat, qddot_pre) + cori + grav
                   - _mv(jc_t, fr_des))[:, 0:6]

        # Inequality rows per leg: the friction pyramid on the total force
        # (stance), or dFr pinned to 0 (swing).
        uf = _uf_rows(config.friction_mu, a_mat)
        max_fz = (params.total_mass * 9.81).to(a_mat.dtype)  # [] or [B]
        ineq_vec = torch.cat([a_mat.new_zeros(max_fz.shape + (5,)),
                              -max_fz[..., None]], dim=-1)  # [6] or [B, 6]
        pin_rows = torch.cat([torch.eye(3, dtype=a_mat.dtype,
                                        device=a_mat.device),
                              a_mat.new_zeros(3, 3)])
        blocks, lows, highs = [], [], []
        for leg in range(4):
            stance = (contact[:, leg] > 0.5)[:, None]            # [B, 1]
            col = 6 + 3 * leg
            # [B, 6, 3]
            leg_rows = torch.where(stance[..., None], uf, pin_rows)
            zeros = leg_rows.new_zeros(b, 6, nz - 3)
            blocks.append(torch.cat([zeros[..., :col], leg_rows,
                                     zeros[..., col:]], dim=-1))
            uf_frdes = fr_des[:, 3 * leg:3 * leg + 3] @ uf.T       # [B, 6]
            lows.append(torch.where(stance, ineq_vec - uf_frdes,
                                    torch.zeros_like(uf_frdes)))
            highs.append(torch.where(stance, torch.full_like(uf_frdes, BIG),
                                     torch.zeros_like(uf_frdes)))
        a_all = torch.cat([a_eq] + blocks, dim=1)
        l_all = torch.cat([rhs_eq] + lows, dim=1)
        u_all = torch.cat([rhs_eq] + highs, dim=1)

    with span("qtpu.wbc.qp"):
        sol = qp.admm_solve(p_cost, q_cost, a_all, l_all, u_all,
                            iters=config.qp_iters)
    qddot = qddot_pre + torch.cat([sol.x[:, 0:6],
                                   torch.zeros_like(sol.x[:, 6:])], dim=-1)
    fr_total = fr_des + sol.x[:, 6:18]
    tot_tau = _mv(a_mat, qddot) + cori + grav - _mv(jc_t, fr_total)
    return tot_tau[:, 6:], qddot, fr_total


def wbc_step(config: WbcConfig, params: RobotParams,
             model: fb.FloatingBaseModel, obs: RobotObservation,
             cmd: WbcCommand):
    """One WBC tick for the batch. Returns (q_des [B, 12], dq_des [B, 12],
    tau_ff [B, 12])."""
    state = fb.FbState(
        quat=obs.base_quat, position=obs.base_position,
        omega_body=obs.base_omega_body,
        vel_body=torch.einsum("bi,bij->bj", obs.base_vel_world,
                              obs.rot_body_to_world),
        q=obs.joint_angles, dq=obs.joint_velocities)
    with span("qtpu.wbc.tasks"):
        jts, jdqds, errs, vels, accs, jc, jcdqd, _ = build_tasks(
            config, model, state, cmd)
        b = state.q.shape[0]
        cmask = torch.repeat_interleave(cmd.contact_state, 3, dim=-1)
        jc_stacked = jc.reshape(b, 12, NDOF) * cmask[..., None]
        delta_q, qdot = multitask_projection(jts, errs, vels, jc_stacked)
    tau_ff, _, _ = wbic_torque(config, params, model, state, cmd,
                               jts, jdqds, accs, jc, jcdqd)
    limit = per_scenario(params, params.torque_limit, 2)
    tau_ff = torch.clamp(tau_ff, -limit, limit)
    return state.q + delta_q[:, 6:], qdot[:, 6:], tau_ff


# The gate's counters, counted by `control/locomotion.py` through this
# reference, bound here, so that a wrapper set on the module's `wbc_step`
# (a profiler's, a test's) does not stand in the way of them: `calls` the
# ticks on which the WBC ran, `skipped` the WBC ticks its gate skipped
# because no scenario was due.
_STEP = wbc_step
_STEP.calls = 0
_STEP.skipped = 0
