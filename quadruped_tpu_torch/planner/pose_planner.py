"""Walk-mode base pose planner, batched (port of quadruped_tpu/planner/pose_planner.py).

During the walk gait's move-base window, plan a 6-D base pose over the
upcoming support polygon and serve interpolated setpoints along it:

  * `plan_target_pose`: the support-centroid heuristic;
  * `plan_target_pose_sqp`: the reference's optimization (leg stretch +
    CoM-to-support-centroid objective, the CoM inside the shrunk support
    polygon, hip-to-foot lengths in [l_min, l_max]) as 10 SQP steps, each
    a 6-variable, 12-row QP solved by solvers/qp.py's ADMM, with the
    Hessian shifted positive definite from its smallest eigenvalue.

`pose_planner_update` runs the SQP only on ticks where some scenario
replans (one host check a tick) and latches the new plan per scenario;
the JAX module's `lax.cond` becomes a select under `vmap`, which runs the
SQP every tick with the same result.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.core import se3, splines
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.solvers import qp as qp_mod
from quadruped_tpu_torch.utils import card

# Leg order around the body of the reference's polygon construction
# (FR, RR, RL, FL).
CCW_ORDER = [0, 2, 3, 1]
OMEGA = 0.5       # CoM-centroid objective weight
EPS_SHRINK = 0.1  # support-polygon shrink factor
L_MIN = 0.22      # virtual leg length bounds
L_MAX = 0.35
BIG = 1e7


@dataclasses.dataclass
class PosePlannerState:
    pose_start: torch.Tensor    # [B, 6] (xyz, rpy) at plan start, world
    pose_target: torch.Tensor   # [B, 6]
    planned: torch.Tensor       # [B] 1.0 once a plan is latched


def pose_planner_init(batch: int, device=None) -> PosePlannerState:
    device = card.resolve(device)
    z6 = torch.zeros(batch, 6, dtype=torch.float32, device=device)
    return PosePlannerState(pose_start=z6, pose_target=z6.clone(),
                            planned=torch.zeros(batch, dtype=torch.float32,
                                                device=device))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _block(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] of [..., 3, 3] blocks."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def plan_target_pose(params: RobotParams, base_position: torch.Tensor,
                     base_rpy: torch.Tensor,
                     foot_positions_world: torch.Tensor,
                     support_mask: torch.Tensor, ground_rpy: torch.Tensor,
                     body_height) -> torch.Tensor:
    """[B, 6] target pose: the CoM over the support centroid, ground
    aligned, yaw kept."""
    ground_rpy = ground_rpy.expand_as(base_rpy)
    n = torch.clamp(torch.sum(support_mask, -1), min=1.0)
    centroid = torch.sum(foot_positions_world * support_mask[..., None],
                         dim=-2) / n[:, None]
    xy = centroid[:, :2] + params.com_offset[:2]
    z = centroid[:, 2] + body_height
    return torch.stack([xy[:, 0], xy[:, 1], z, ground_rpy[:, 0],
                        ground_rpy[:, 1], base_rpy[:, 2]], dim=-1)


def _so3_quat(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map so3 -> unit quaternion."""
    angle = _norm(phi)
    axis = phi / torch.clamp(angle, min=1e-9)[..., None]
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def _polygon_rows(verts_xy: torch.Tensor, valid: torch.Tensor, eps: float):
    """Edge half-planes of the shrunk support polygon: verts_xy [B, 4, 2]
    CCW candidates, valid [B, 4]. Returns (a [B, 4, 2], b [B, 4], valid)
    with a . x >= b inside; each valid vertex joins the next valid one in
    the cyclic order."""
    n = torch.clamp(torch.sum(valid, -1), min=1.0)
    center = torch.sum(verts_xy * valid[..., None], dim=-2) / n[:, None]
    shrunk = center[:, None] + (1.0 - eps) * (verts_xy - center[:, None])
    idx = torch.arange(4, device=valid.device)
    cand = (idx[:, None] + idx[None, :] + 1) % 4                 # [4, 4]
    ok = (valid[:, cand] > 0.5).to(torch.uint8)                  # [B, 4, 4]
    nxt = cand[idx, torch.argmax(ok, dim=-1)]                    # [B, 4]
    a = shrunk
    b = torch.gather(shrunk, 1, nxt[..., None].expand(-1, -1, 2))
    rows = torch.stack([b[..., 1] - a[..., 1], a[..., 0] - b[..., 0]], -1)
    bs = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    return rows, bs, valid


def _drop_concave_vertex(verts_xy: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """With four contacts, drop the first vertex that makes the quad
    concave (the reference's sequential check over source vertices 1, 2)."""
    four = torch.sum(valid, -1) > 3.5

    def checks(source_id):
        dest = (source_id + 2) % 4
        pos, neg = source_id - 1, (source_id + 1) % 4
        s, d = verts_xy[:, source_id], verts_xy[:, dest]
        cp, cn = verts_xy[:, pos], verts_xy[:, neg]
        cross_p = ((d[:, 0] - s[:, 0]) * (cp[:, 1] - s[:, 1])
                   - (d[:, 1] - s[:, 1]) * (cp[:, 0] - s[:, 0]))
        cross_n = ((d[:, 0] - s[:, 0]) * (cn[:, 1] - s[:, 1])
                   - (d[:, 1] - s[:, 1]) * (cn[:, 0] - s[:, 0]))
        return cross_p, cross_n, pos, neg

    cp1, cn1, p1, n1 = checks(1)
    cp2, cn2, p2, n2 = checks(2)
    none = torch.full_like(four, -1, dtype=torch.int64)
    invalid = torch.where(cp1 > 0, p1, torch.where(
        cn1 < 0, n1, torch.where(cp2 > 0, p2, torch.where(cn2 < 0, n2,
                                                          none))))
    drop = (four & (invalid >= 0))[:, None] \
        & (torch.arange(4, device=valid.device) == invalid[:, None])
    return torch.where(drop, torch.zeros_like(valid), valid)


def plan_target_pose_sqp(params: RobotParams, base_position: torch.Tensor,
                         base_rpy: torch.Tensor,
                         foot_positions_world: torch.Tensor,
                         support_mask: torch.Tensor,
                         ground_rpy: torch.Tensor, body_height, *,
                         omega: float = OMEGA, eps: float = EPS_SHRINK,
                         l_min: float = L_MIN, l_max: float = L_MAX,
                         omega_rot: float = 1.0, sqp_iters: int = 10,
                         qp_iters: int = 60) -> torch.Tensor:
    """[B, 6] optimized target pose (reference qrPosePlanner::Update).

    Per SQP step the variables are p = [d_rIB (3), d_phi (3)], the
    orientation updated as quat <- exp(d_phi) * quat; the rows are the
    support-polygon half-planes on the CoM and l_min <= |g_i| <= l_max on
    the virtual hip-to-foot legs, masked to the valid contacts. omega_rot
    anchors the orientation to the ground frame (roll and pitch of
    ground_rpy, yaw held). Every tensor follows base_position's dtype, so
    a float64 run takes float64 inputs and parameters."""
    dtype = base_position.dtype
    ground_rpy = ground_rpy.expand_as(base_rpy)
    quat = se3.rpy_to_quat(base_rpy)
    r_if = foot_positions_world[:, CCW_ORDER]                 # [B, 4, 3]
    r_bh = params.hip_offset[CCW_ORDER].to(dtype)             # [4, 3]
    valid = _drop_concave_vertex(r_if[..., :2], support_mask[:, CCW_ORDER])
    n_c = torch.clamp(torch.sum(valid, -1), min=1.0)

    # Support-centroid target: the contact mean blended 2:1 with the mean
    # of all feet; height = mean contact height + body height.
    contact_mean = torch.sum(r_if * valid[..., None], dim=-2) / n_c[:, None]
    all_mean = torch.mean(r_if, dim=-2)
    r_sp = contact_mean * (2.0 / 3.0) + all_mean / 3.0
    r_sp = torch.cat([r_sp[:, :2], (contact_mean[:, 2] + body_height)[:, None]],
                     dim=-1)

    a_sp, b_sp, poly_valid = _polygon_rows(r_if[..., :2], valid, eps)
    a_sp3 = torch.cat([a_sp, torch.zeros_like(a_sp[..., :1])], dim=-1)
    j_poly = torch.cat([a_sp3, torch.zeros_like(a_sp3)], dim=-1)
    row_valid = torch.cat([poly_valid, valid, valid], dim=-1)
    eye3, eye6 = _eye(3, r_if), _eye(6, r_if)
    vm = valid[..., None, None]

    r_ib = base_position
    lam = torch.full_like(row_valid, 0.1)
    for _ in range(sqp_iters):
        r = se3.quat_to_rotmat(quat)
        r_bf = torch.einsum("bji,blj->bli", r, r_if - r_ib[:, None])
        r_world = torch.einsum("bij,blj->bli", r, r_bf)
        r1 = (r_ib[:, None] + r_world - r_if) * valid[..., None]
        r_ibh = torch.einsum("bij,lj->bli", r, r_bh)
        g = r_ib[:, None] + r_ibh - r_if                      # [B, 4, 3]
        g_norm = torch.clamp(_norm(g), min=1e-6)
        g_hat = g / g_norm[..., None]

        # Objective quadratic model.
        grad_t = torch.sum(r1, dim=-2) + omega * (r_ib - r_sp)
        grad_w = torch.sum(torch.linalg.cross(r_world, r_ib[:, None] - r_if)
                           * valid[..., None], dim=-2)
        rpy_now = se3.quat_to_rpy(quat)
        r_anchor = se3.rpy_to_rotmat(torch.stack(
            [ground_rpy[:, 0], ground_rpy[:, 1], rpy_now[:, 2]], -1))
        grad_w = grad_w + omega_rot * se3.so3_log(
            r @ r_anchor.transpose(-1, -2))
        grad_f = 2.0 * torch.cat([grad_t, grad_w], dim=-1)

        skews = se3.skew(r_world)                             # [B, 4, 3, 3]
        sk_rel = se3.skew(r_ib[:, None] - r_if)
        h_tt = eye3 * (n_c + omega)[:, None, None]
        h_tw = -torch.sum(skews * vm, dim=-3)
        d_mats = 0.5 * (sk_rel @ skews + skews @ sk_rel)
        h_ww = torch.sum(d_mats * vm, dim=-3) + omega_rot * eye3
        hess_f = 2.0 * _block(h_tt, h_tw, -h_tw, h_ww)

        # Constraint values and Jacobians.
        g_poly = torch.einsum("bli,bi->bl", a_sp3, r_ib) - b_sp
        g_val = torch.cat([g_poly, g_norm - l_min, l_max - g_norm], dim=-1)
        sk_h = se3.skew(r_ibh)                                # [B, 4, 3, 3]
        dgdphi = -torch.einsum("bli,blij->blj", g_hat, sk_h)
        j_len = torch.cat([g_hat, dgdphi], dim=-1)
        jac = torch.cat([j_poly, j_len, -j_len], dim=-2)      # [B, 12, 6]

        # Lagrangian Hessian of the length rows (the polygon rows are
        # linear in p).
        p_tt = (eye3 - g_hat[..., :, None] * g_hat[..., None, :]) \
            / g_norm[..., None, None]
        p_tw = -p_tt @ sk_h
        dh = 0.5 * (sk_rel @ sk_h + sk_h @ sk_rel)
        p_ww = (0.5 * dh - dgdphi[..., :, None] * dgdphi[..., None, :]) \
            / g_norm[..., None, None]
        h_len = _block(p_tt, p_tw, -p_tw.transpose(-1, -2), p_ww)
        hess_g = torch.einsum("bl,blij->bij",
                              (lam[:, 4:8] - lam[:, 8:12]) * valid, h_len)

        # PD safeguard: shift by the most negative eigenvalue.
        h_mat = hess_f - hess_g
        eig_min = torch.amin(torch.linalg.eigvalsh(h_mat), dim=-1)
        h_mat = h_mat + torch.clamp(1e-3 - eig_min, min=0.0)[:, None, None] \
            * eye6
        lo = torch.where(row_valid > 0.5, -g_val, torch.full_like(g_val, -BIG))
        sol = qp_mod.admm_solve(h_mat, grad_f, jac, lo,
                                torch.full_like(g_val, BIG), iters=qp_iters)
        p = sol.x
        lam = torch.clamp(-sol.y, min=0.0) * row_valid
        r_ib = r_ib + p[:, :3]
        quat = se3.quat_mul(_so3_quat(p[:, 3:]), quat)
        quat = quat / _norm(quat)[:, None]

    rpy = se3.quat_to_rpy(quat)
    # Pitch blended with the ground pitch.
    pitch = 0.5 * (rpy[:, 1] + ground_rpy[:, 1])
    return torch.cat([r_ib, rpy[:, :1], pitch[:, None], rpy[:, 2:]], dim=-1)


def pose_planner_update(state: PosePlannerState, params: RobotParams, *,
                        base_position: torch.Tensor, base_rpy: torch.Tensor,
                        foot_positions_world: torch.Tensor,
                        support_mask: torch.Tensor, ground_rpy: torch.Tensor,
                        body_height, replan: torch.Tensor,
                        use_sqp: bool = True) -> PosePlannerState:
    """Latch a new plan in the scenarios where `replan` [B] fires or no
    plan is latched yet. With use_sqp the SQP runs (for the whole batch)
    only when some scenario latches; else the centroid heuristic."""
    do = (replan > 0.5) | (state.planned < 0.5)
    if not use_sqp:
        target = plan_target_pose(params, base_position, base_rpy,
                                  foot_positions_world, support_mask,
                                  ground_rpy, body_height)
    elif bool(do.any()):
        target = plan_target_pose_sqp(params, base_position, base_rpy,
                                      foot_positions_world, support_mask,
                                      ground_rpy, body_height)
    else:
        target = state.pose_target
    current = torch.cat([base_position, base_rpy], dim=-1)
    return PosePlannerState(
        pose_start=torch.where(do[:, None], current, state.pose_start),
        pose_target=torch.where(do[:, None], target, state.pose_target),
        planned=torch.ones_like(state.planned))


def intermediate_base_pose(state: PosePlannerState, phase: torch.Tensor):
    """(pose [B, 6], twist [B, 6]) at `phase` [B] along the planned
    segment: a cubic with zero end velocities."""
    zeros = torch.zeros_like(state.pose_start)
    return splines.cubic_hermite(state.pose_start, zeros, state.pose_target,
                                 zeros, phase[..., None])
