"""Batched floating-base (Featherstone) rigid-body dynamics, fixed topology (a frozen copy of the port's twin of quadruped_tpu/dynamics/floating_base.py).

A 6-DoF floating trunk plus 4 legs x (abad about X, hip about Y, knee
about Y), rotor-free, as the JAX module builds it. The four legs are
identical depth-3 chains that couple only through the trunk, so every sweep
is three sequential chain steps over a leg axis ([B, 4, 6, 6] tensors),
and the 18 x 18 mass matrix and 3 x 18 Jacobians assemble from blocks. The
small products are the JAX module's elementwise broadcast-reduce forms
(`_mv`, `_mtv`, `se3.matmul3`), kept for parity of summation order.

Generalized velocity = [omega_body(3); v_body(3); qdot(12)], base
velocities in the body frame. Joint ji = 3*leg + depth; body = 1 + ji.
Leg order FR, FL, RR, RL. Batch-first: every state tensor carries the
leading scenario axis; the model is shared by the batch (no leading axis,
`build_model` of one robot) or given per scenario (a leading [B] axis on
each of its tensors, `build_model` of a fleet, `params.stack_params`),
and a model of B robots takes only states of B scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference import se3
from portbench.reference import spatial as sp
from portbench.reference.params import (SIDE_SIGN, RobotParams,
                                               index_own)

NUM_DOF = 18          # 6 floating + 12 revolute
NUM_LEGS = 4
CHAIN = 3             # links per leg
DEPTH_AXES = (0, 1, 1)
GRAVITY = (0.0, 0.0, -9.81)

_mm = se3.matmul3


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., m, n] @ [..., n], elementwise."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., n, m]^T @ [..., n], elementwise (force transform X^T f)."""
    return torch.sum(m * v[..., :, None], dim=-2)


def _blockdiag_legs(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 4, r, c] -> [..., 4, r, 4, c]: leg l's block in column block l,
    zeros elsewhere (the JAX module's identity einsum)."""
    eye4 = torch.eye(NUM_LEGS, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("...lij,lm->...limj", blocks, eye4)


@dataclasses.dataclass
class FloatingBaseModel:
    """Static model data; each tensor may carry a leading scenario axis."""

    xtree_r: torch.Tensor       # [13, 3] parent->joint translations
    inertias: torch.Tensor      # [13, 6, 6] spatial inertias, link frames
    foot_offset: torch.Tensor   # [4, 3] foot point in knee-link frame

    def check_batch(self, batch) -> None:
        """Raise ValueError where a model of B robots meets states whose
        leading axes `batch` are not [B] (they would broadcast)."""
        if self.xtree_r.ndim == 3 and tuple(batch) != self.xtree_r.shape[:1]:
            raise ValueError(f"a model of {self.xtree_r.shape[0]} robots "
                             f"for states of batch {tuple(batch)}")

    @property
    def xtree_legs(self) -> torch.Tensor:
        """[..., 4, 3(depth), 3] leg-stacked parent->joint translations."""
        return self.xtree_r[..., 1:, :].reshape(
            self.xtree_r.shape[:-2] + (NUM_LEGS, CHAIN, 3))

    @property
    def inertia_legs(self) -> torch.Tensor:
        """[..., 4, 3(depth), 6, 6] leg-stacked link spatial inertias."""
        return self.inertias[..., 1:, :, :].reshape(
            self.inertias.shape[:-3] + (NUM_LEGS, CHAIN, 6, 6))


@dataclasses.dataclass
class FbState:
    """Dynamic state of the floating-base model, batch-first."""

    quat: torch.Tensor        # [B, 4] body->world
    position: torch.Tensor    # [B, 3] world
    omega_body: torch.Tensor  # [B, 3]
    vel_body: torch.Tensor    # [B, 3]
    q: torch.Tensor           # [B, 12]
    dq: torch.Tensor          # [B, 12]


def build_model(params: RobotParams) -> FloatingBaseModel:
    """The 13-body model of the robot in `params`, on params' device; for
    a fleet, each tensor with the leading scenario axis (what `jax.vmap`
    of the JAX `build_model` gives)."""
    zero = torch.zeros_like(params.total_mass)         # [] or [B]

    def vec(*xs):
        return torch.stack(xs, dim=-1)

    xtree = [vec(zero, zero, zero)]
    inertias = [sp.spatial_inertia(params.body_mass, vec(zero, zero, zero),
                                   params.body_inertia)]
    for leg in range(NUM_LEGS):
        side = SIDE_SIGN[leg]
        xtree.append(index_own(params, params.hip_offset, leg))
        xtree.append(vec(zero, params.hip_length * side, zero))
        xtree.append(vec(zero, zero, -params.upper_length))
        for link in range(CHAIN):
            m = index_own(params, params.links_mass, link)
            com = index_own(params, params.links_com_pos, link)
            i_com = index_own(params, params.links_inertia, link)
            if side < 0:
                m, com, i_com = sp.flip_inertia_along_y(m, com, i_com)
            inertias.append(sp.spatial_inertia(m, com, i_com))
    # Foot contact point on the knee link: a 4 mm lateral offset with the
    # leg's side sign.
    foot_offset = torch.stack([
        vec(zero, torch.full_like(zero, -0.004 * SIDE_SIGN[leg]),
            -params.lower_length)
        for leg in range(NUM_LEGS)], dim=-2)
    return FloatingBaseModel(xtree_r=torch.stack(xtree, dim=-2),
                             inertias=torch.stack(inertias, dim=-3),
                             foot_offset=foot_offset)


class _LegKinematics(NamedTuple):
    """xup [B, 4, 3, 6, 6] child-from-parent transforms per depth; v and c
    [B, 4, 3, 6] link velocities and velocity-product accelerations; v0
    [B, 6] base spatial velocity."""

    xup: torch.Tensor
    v: torch.Tensor
    c: torch.Tensor
    v0: torch.Tensor


def _joint_xforms(model: FloatingBaseModel, q: torch.Tensor) -> torch.Tensor:
    """[B, 4, 3(depth), 6, 6] X_up per joint."""
    model.check_batch(q.shape[:-1])
    q_legs = q.reshape(q.shape[:-1] + (NUM_LEGS, CHAIN))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    xups = []
    for d in range(CHAIN):
        xj = sp.joint_transform_revolute(DEPTH_AXES[d], q_legs[..., :, d])
        xt = sp.spatial_transform(eye, model.xtree_legs[..., :, d, :])
        xups.append(_mm(xj, xt))
    return torch.stack(xups, dim=-3)


def _forward_pass(model: FloatingBaseModel, q: torch.Tensor,
                  dq: torch.Tensor, v_base: torch.Tensor) -> _LegKinematics:
    """Outward sweep: three depth steps over the 4 legs."""
    batch = q.shape[:-1]
    dq_legs = dq.reshape(batch + (NUM_LEGS, CHAIN))
    xup = _joint_xforms(model, q)
    v_parent = v_base[..., None, :].expand(batch + (NUM_LEGS, 6))
    vs, cs = [], []
    for d in range(CHAIN):
        s = sp.joint_motion_subspace(DEPTH_AXES[d], q.dtype, q.device)
        vj = s * dq_legs[..., :, d, None]
        v_d = _mv(xup[..., d, :, :], v_parent) + vj
        cs.append(sp.motion_cross(v_d, vj))
        vs.append(v_d)
        v_parent = v_d
    return _LegKinematics(xup=xup, v=torch.stack(vs, dim=-2),
                          c=torch.stack(cs, dim=-2), v0=v_base)


def mass_matrix(model: FloatingBaseModel, q: torch.Tensor) -> torch.Tensor:
    """[B, 18, 18] CRBA: [[H_bb, H_bl], [H_bl^T, blockdiag_legs(H_ll)]],
    assembled from leg-stacked blocks."""
    batch = q.shape[:-1]
    xup = _joint_xforms(model, q)
    x0, x1, x2 = (xup[..., d, :, :] for d in range(CHAIN))
    i_legs = model.inertia_legs

    def sandwich(x, ic):
        """X^T ic X (composite inertia in the parent frame)."""
        return _mm(x.transpose(-1, -2), _mm(ic, x))

    # Backward composite sweep: knee -> hip -> abad -> trunk.
    ic2 = i_legs[..., 2, :, :].expand(batch + (NUM_LEGS, 6, 6))
    ic1 = i_legs[..., 1, :, :] + sandwich(x2, ic2)
    ic0 = i_legs[..., 0, :, :] + sandwich(x1, ic1)
    ic_base = model.inertias[..., 0, :, :] + torch.sum(sandwich(x0, ic0),
                                                       dim=-3)
    ic_base = ic_base.expand(batch + (6, 6))

    # Joint forces I_c S per depth (S picks column X for abad, Y for hip
    # and knee), carried down the chain with X^T.
    f2 = ic2[..., :, :, 1]
    f1 = ic1[..., :, :, 1]
    f0 = ic0[..., :, :, 0]
    h22 = f2[..., 1]
    f2_h = _mtv(x2, f2)
    h21 = f2_h[..., 1]
    f2_a = _mtv(x1, f2_h)
    h20 = f2_a[..., 0]
    f2_b = _mtv(x0, f2_a)
    h11 = f1[..., 1]
    f1_a = _mtv(x1, f1)
    h10 = f1_a[..., 0]
    f1_b = _mtv(x0, f1_a)
    h00 = f0[..., 0]
    f0_b = _mtv(x0, f0)

    h_ll = torch.stack([
        torch.stack([h00, h10, h20], dim=-1),
        torch.stack([h10, h11, h21], dim=-1),
        torch.stack([h20, h21, h22], dim=-1),
    ], dim=-2)                                          # [B, 4, 3, 3]
    h_bl = torch.stack([f0_b, f1_b, f2_b], dim=-1)      # [B, 4, 6, 3]
    h_joint = _blockdiag_legs(h_ll).reshape(batch + (12, 12))
    h_bl_full = h_bl.transpose(-3, -2).reshape(batch + (6, 12))
    top = torch.cat([ic_base, h_bl_full], dim=-1)
    bottom = torch.cat([h_bl_full.transpose(-1, -2), h_joint], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _bias_force_pass(model: FloatingBaseModel, kin: _LegKinematics,
                     a_base: torch.Tensor, batch,
                     with_velocity: bool) -> torch.Tensor:
    """RNEA with qdd = 0: the generalized force for a base acceleration;
    with_velocity=False drops the velocity-product terms (gravity only)."""
    xup = kin.xup
    i_legs = model.inertia_legs
    a_parent = a_base[..., None, :].expand(batch + (NUM_LEGS, 6))
    a_depth = []
    for d in range(CHAIN):
        a_d = _mv(xup[..., d, :, :], a_parent)
        if with_velocity:
            a_d = a_d + kin.c[..., d, :]
        a_depth.append(a_d)
        a_parent = a_d
    a_legs = torch.stack(a_depth, dim=-2)               # [B, 4, 3, 6]

    f_legs = _mv(i_legs, a_legs)
    i_base = model.inertias[..., 0, :, :]
    f0 = _mv(i_base, a_base)
    if with_velocity:
        f_legs = f_legs + sp.force_cross(kin.v, _mv(i_legs, kin.v))
        f0 = f0 + sp.force_cross(kin.v0, _mv(i_base, kin.v0))

    # Inward sweep: project onto the joint axes, accumulate into parents.
    f_knee = f_legs[..., 2, :]
    tau_knee = f_knee[..., 1]
    f_hip = f_legs[..., 1, :] + _mtv(xup[..., 2, :, :], f_knee)
    tau_hip = f_hip[..., 1]
    f_abad = f_legs[..., 0, :] + _mtv(xup[..., 1, :, :], f_hip)
    tau_abad = f_abad[..., 0]
    f0 = f0 + torch.sum(_mtv(xup[..., 0, :, :], f_abad), dim=-2)

    tau_legs = torch.stack([tau_abad, tau_hip, tau_knee],
                           dim=-1).reshape(batch + (12,))
    return torch.cat([f0.expand(batch + (6,)), tau_legs], dim=-1)


def _gravity_accel_base(quat: torch.Tensor) -> torch.Tensor:
    """Spatial 'acceleration' -a_g in the base frame."""
    r = se3.quat_to_rotmat(quat)
    g_world = torch.as_tensor(GRAVITY, dtype=quat.dtype, device=quat.device)
    g_body = torch.einsum("...ji,j->...i", r, g_world)
    return torch.cat([torch.zeros_like(g_body), -g_body], dim=-1)


def _v_base(state: FbState) -> torch.Tensor:
    return torch.cat([state.omega_body, state.vel_body], dim=-1)


def gravity_force(model: FloatingBaseModel, state: FbState) -> torch.Tensor:
    """[B, 18] generalized gravity force."""
    batch = state.q.shape[:-1]
    kin = _forward_pass(model, state.q, torch.zeros_like(state.q),
                        state.q.new_zeros(batch + (6,)))
    return _bias_force_pass(model, kin, _gravity_accel_base(state.quat),
                            batch, with_velocity=False)


def coriolis_force(model: FloatingBaseModel, state: FbState) -> torch.Tensor:
    """[B, 18] generalized Coriolis and centrifugal force."""
    batch = state.q.shape[:-1]
    kin = _forward_pass(model, state.q, state.dq, _v_base(state))
    return _bias_force_pass(model, kin, state.q.new_zeros(batch + (6,)),
                            batch, with_velocity=True)


def _leg_rotations_positions(model: FloatingBaseModel, state: FbState):
    """(r_base [B, 3, 3], rots [B, 4, 3, 3, 3], poss [B, 4, 3, 3], kin):
    rots[:, l, d] is the world rotation of link (l, d), poss[:, l, d] its
    joint origin in world."""
    r_base = se3.quat_to_rotmat(state.quat)
    kin = _forward_pass(model, state.q, state.dq, _v_base(state))
    batch = state.q.shape[:-1]
    xtree = model.xtree_legs.expand(batch + (NUM_LEGS, CHAIN, 3))
    rot_parent = r_base[..., None, :, :].expand(batch + (NUM_LEGS, 3, 3))
    pos_parent = state.position[..., None, :].expand(batch + (NUM_LEGS, 3))
    rots, poss = [], []
    for d in range(CHAIN):
        pos_d = pos_parent + _mv(rot_parent, xtree[..., :, d, :])
        e = sp.rotation_part(kin.xup[..., d, :, :])   # child_R_parent
        rot_d = _mm(rot_parent, e.transpose(-1, -2))
        rots.append(rot_d)
        poss.append(pos_d)
        rot_parent, pos_parent = rot_d, pos_d
    return r_base, torch.stack(rots, dim=-3), torch.stack(poss, dim=-2), kin


def contact_jacobians(model: FloatingBaseModel, state: FbState):
    """World-frame foot Jacobians and bias accelerations: (jc [B, 4, 3, 18],
    jcdqd [B, 4, 3], p_feet [B, 4, 3]); the linear foot velocity in world is
    jc @ [w_b; v_b; qd]."""
    r_base, rots, poss, kin = _leg_rotations_positions(model, state)
    batch = state.q.shape[:-1]
    cross = torch.linalg.cross
    p_foot = poss[..., :, 2, :] + _mv(rots[..., :, 2, :, :],
                                      model.foot_offset)

    # Base columns: v_foot = R (v_b + w_b x r_rel_body) + joint terms.
    r_legs = r_base[..., None, :, :].expand(batch + (NUM_LEGS, 3, 3))
    r_rel = _mtv(r_legs, p_foot - state.position[..., None, :])
    base_w = -_mm(r_base[..., None, :, :], se3.skew(r_rel))
    base_v = r_legs

    # Joint columns: axis_world x (p_foot - joint origin) per depth, each
    # leg filling its own 3 of the 12 joint columns.
    cols = torch.stack([
        cross(rots[..., :, d, :, DEPTH_AXES[d]], p_foot - poss[..., :, d, :])
        for d in range(CHAIN)], dim=-1)                 # [B, 4, 3, 3]
    joint_cols = _blockdiag_legs(cols).reshape(
        batch + (NUM_LEGS, 3, 12))
    jc = torch.cat([base_w, base_v, joint_cols], dim=-1)

    # Bias acceleration Jdot qd: velocity-product sweep (qdd = 0), then the
    # classical acceleration of the offset contact point, in world.
    a_parent = state.q.new_zeros(batch + (NUM_LEGS, 6))
    for d in range(CHAIN):
        a_parent = _mv(kin.xup[..., d, :, :], a_parent) + kin.c[..., d, :]
    v_knee = kin.v[..., 2, :]
    w, vl = v_knee[..., 0:3], v_knee[..., 3:6]
    aw, al = a_parent[..., 0:3], a_parent[..., 3:6]
    r_off = model.foot_offset.expand(w.shape)
    a_pt = al + cross(aw, r_off) + cross(w, vl + cross(w, r_off))
    bias = _mv(rots[..., :, 2, :, :], a_pt)
    return jc, bias, p_foot


