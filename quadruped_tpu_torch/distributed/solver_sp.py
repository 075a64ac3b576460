"""Solver-parallel (sp-axis) cone-QP solve: the [12H] force axis split over
ranks (port of quadruped_tpu/distributed/solver_sp.py).

`cone_qp.solve` re-reads M^{-1} ([B, n, n]) every ADMM iteration. This
variant splits the VARIABLE axis (n = 12H forces = 4H triples) over the
mesh's `sp` axis:

  * each sp rank streams only its n/sp column block of M^{-1} an
    iteration;
  * the x-update is a partial product plus one `all_reduce` (SUM) of the
    [B_local, n] iterate over the sp group an iteration;
  * the constraint work (cone projection, duals, rho rows) stays on each
    rank's 4H/sp triples, with no communication;
  * the batch stays split over `dp`: every sp rank of a dp group passes
    the same rows (its dp group's `shard_batch` rows) and gets the whole
    solution back.

Equilibration and the Newton-Schulz inverse (the port's
`cone_qp._equilibrate_scales`, `cone_pattern`, `_project` and
`newton_schulz_inverse`, with the JAX bf16 casts) run on every sp rank
alike: once a solve against `iters` passes over M^{-1}. The loop is plain
torch: K1 (`fused_admm`) cannot make a collective inside its loop, and the
JAX module is plain jnp too.

STATUS (the JAX package's measurement): correct, but unprofitable in every
regime tried (sp = 2-4 ran 2-3x slower than sp = 1 at H = 10 and H = 16,
batches 8-64, on a virtual CPU mesh): the per-iteration reduction costs
more than the mat-vec it saves at these problem sizes. sp = 1, the
`make_mesh` default, is the choice everywhere until a measurement on
several cards says otherwise.

Semantics match `cone_qp.solve` (splitting, scaling, the pinned-row rho
boost, Fast-ADMM momentum, x_t = M^{-1} rhs).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quadruped_tpu_torch.distributed.mesh import mesh_shape
from quadruped_tpu_torch.solvers import cone_qp
from quadruped_tpu_torch.solvers.cone_qp import (NS_ITERS, RHO_CONE, SIGMA,
                                                 ConeQP, ConeSolution)


def solve_cone_sp(mesh: DeviceMesh, prob: ConeQP, *, iters: int = 24,
                  rho: float = RHO_CONE, sigma: float = SIGMA,
                  alpha: float = 1.0, accel_restart: int = 20,
                  x0: torch.Tensor | None = None,
                  y0: torch.Tensor | None = None,
                  ns_iters: int = NS_ITERS,
                  ns_f32_polish: int = 1) -> ConeSolution:
    """The cone solve of this rank's dp rows with the variable axis split
    over the mesh's sp ranks.

    prob: [B_local] problems, the same on every sp rank of the dp group;
    the triple count T = n/3 must divide by sp. Warm starts x0 [B, n] and
    y0 [B, T, 5]. Returns the whole solution (x [B, n], y [B, T, 5],
    prim_res [B]) on every sp rank. The per-shape set-up is cached per
    (sp layout, n, dtype, device)."""
    b, n, _ = prob.p.shape
    sp = mesh_shape(mesh)["sp"]
    k = mesh.get_local_rank("sp")
    group = mesh.get_group("sp")
    dtype, device = prob.p.dtype, prob.p.device
    plan = _build_solver(sp, k, n, dtype, str(device))
    t_loc, col, trip = plan["t_loc"], plan["col"], plan["trip"]
    n_loc = 3 * t_loc
    if x0 is None:
        x0 = torch.zeros(b, n, dtype=dtype, device=device)
    if y0 is None:
        y0 = torch.zeros(b, n // 3, 5, dtype=dtype, device=device)

    q_s, d, _, gamma, fz_lo_s, fz_hi_s = cone_qp._equilibrate_scales(prob)
    pattern = cone_qp.cone_pattern(prob.mu)                   # [B, 5, 3]
    pat_t = pattern.transpose(-1, -2)
    pinned = ((fz_hi_s - fz_lo_s) < 1e-6)[..., None]
    rho_rows = rho * (1.0 + 99.0 * pinned * plan["row_template"])
    ata = torch.einsum("bir,btr,brj->btij", pat_t, rho_rows, pattern)
    scale = gamma[:, None, None] * d[:, :, None] * d[:, None, :]
    m_mat = scale * prob.p + sigma * plan["eye_n"] + torch.einsum(
        "btij,tu->btiuj", ata, plan["eye_t"]).reshape(b, n, n)
    m_inv = cone_qp.newton_schulz_inverse(m_mat, ns_iters, ns_f32_polish)

    # This rank's column block of M^{-1} and its triples.
    m_inv_cols = m_inv[:, :, col].contiguous()               # [B, n, n_loc]
    rho_loc = rho_rows[:, trip]
    fz_lo_loc, fz_hi_loc = fz_lo_s[:, trip], fz_hi_s[:, trip]
    q_loc = q_s[:, col]

    def apply_a_loc(x_loc):
        return torch.einsum("bri,bti->btr", pattern,
                            x_loc.reshape(b, t_loc, 3))

    def apply_at_loc(w_loc):
        return torch.einsum("bir,btr->bti", pat_t, w_loc).reshape(b, n_loc)

    def x_update(x_full, zz_loc, yy_loc):
        """Local rhs -> partial mat-vec -> all_reduce over sp."""
        rhs_loc = sigma * x_full[:, col] - q_loc \
            + apply_at_loc(rho_loc * zz_loc - yy_loc)
        part = torch.einsum("bnc,bc->bn", m_inv_cols, rhs_loc)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        return part

    x = x0 / d
    y = (y0 * gamma[:, None, None])[:, trip]
    z = cone_qp._project(apply_a_loc(x[:, col]), fz_lo_loc, fz_hi_loc)
    if accel_restart > 0:
        z_hat, y_hat = z, y
        tk = np.float32(1.0)
        for kk in range(iters):
            x_t = x_update(x, z_hat, y_hat)
            z_t = apply_a_loc(x_t[:, col])
            x = alpha * x_t + (1 - alpha) * x
            z_rel = alpha * z_t + (1 - alpha) * z_hat
            z_new = cone_qp._project(z_rel + y_hat / rho_loc, fz_lo_loc,
                                     fz_hi_loc)
            y_new = y_hat + rho_loc * (z_rel - z_new)
            if kk % accel_restart == accel_restart - 1:
                tk_next, beta = np.float32(1.0), np.float32(0.0)
            else:
                tk_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
                    np.float32(1.0) + np.float32(4.0) * tk * tk))
                beta = (tk - np.float32(1.0)) / tk_next
            z_hat = z_new + float(beta) * (z_new - z)
            y_hat = y_new + float(beta) * (y_new - y)
            z, y, tk = z_new, y_new, tk_next
    else:
        for _ in range(iters):
            x_t = x_update(x, z, y)
            z_t = apply_a_loc(x_t[:, col])
            x = alpha * x_t + (1 - alpha) * x
            z_rel = alpha * z_t + (1 - alpha) * z
            z_new = cone_qp._project(z_rel + y / rho_loc, fz_lo_loc,
                                     fz_hi_loc)
            y = y + rho_loc * (z_rel - z_new)
            z = z_new

    x_out = x * d
    parts = [torch.empty_like(y) for _ in range(sp)]
    dist.all_gather(parts, y.contiguous(), group=group)
    y_out = torch.cat(parts, dim=1) / gamma[:, None, None]
    ax_loc = apply_a_loc(x_out[:, col])
    ax_proj = cone_qp._project(ax_loc, prob.fz_lo[:, trip],
                               prob.fz_hi[:, trip])
    prim = torch.amax(torch.abs(ax_loc - ax_proj), dim=(-2, -1))
    dist.all_reduce(prim, op=dist.ReduceOp.MAX, group=group)
    return ConeSolution(x=x_out, y=y_out, prim_res=prim)


@functools.lru_cache(maxsize=64)
def _build_solver(sp: int, k: int, n: int, dtype: torch.dtype,
                  device: str) -> dict:
    """The per-shape set-up of rank k of sp: its column and triple slices,
    the identities and the pinned-row template."""
    t = n // 3
    if t % sp:
        raise ValueError(f"{t} force triples do not split over sp={sp}")
    t_loc = t // sp
    return {"t_loc": t_loc,
            "col": slice(3 * t_loc * k, 3 * t_loc * (k + 1)),
            "trip": slice(t_loc * k, t_loc * (k + 1)),
            "eye_n": torch.eye(n, dtype=dtype, device=device),
            "eye_t": torch.eye(t, dtype=dtype, device=device),
            "row_template": torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0],
                                         dtype=dtype, device=device)}
