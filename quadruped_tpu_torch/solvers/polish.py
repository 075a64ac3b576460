"""Exact batched solver for near-singular factored QPs (port of quadruped_tpu/solvers/polish.py).

    min 1/2 x^T (C^T C + reg I) x + q^T x   s.t.  l <= A x <= u

The force-balance stance QP has this shape with kappa(P) ~ 1e8: the tiny
regularizer decides the per-leg force split along the internal-force modes,
where first-order methods stall. Three stages, as in the JAX module:

1. WHITEN: the one-sided Jacobi SVD of C^T gives P^{1/2} and P^{-1/2} in
   closed form; in xi = P^{1/2} x the Hessian is the identity and the
   constraint rows are normalized to unit norm.
2. ADMM in the whitened frame (solvers/qp.py, scale=False).
3. POLISH: a single-pivot primal-dual active-set iteration (add the most
   violated row or drop the worst wrong-sign multiplier, one per pass),
   each pass solving the masked range-space KKT system with the block-Schur
   inverse, keeping the best-KKT iterate.

Static shapes, no data-dependent branch: the passes run for every scenario,
and a scenario whose KKT residual is tight stops pivoting.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_tpu_torch.core import linalg
from quadruped_tpu_torch.solvers import qp


class FactoredQP(NamedTuple):
    c: torch.Tensor     # [..., k, n] cost factor (P = c^T c + reg I)
    reg: float
    q: torch.Tensor     # [..., n]
    a: torch.Tensor     # [..., m, n]
    l: torch.Tensor     # [..., m]
    u: torch.Tensor     # [..., m]


def whiten_factors(c: torch.Tensor, reg: float):
    """(P^{1/2}, P^{-1/2}) for P = c^T c + reg I, via Jacobi SVD of c^T."""
    ct = c.transpose(-1, -2)                            # [..., n, k]
    n = ct.shape[-2]
    v, s = linalg.onesided_jacobi_svd(ct)               # [..., n, k], [..., k]
    lam = s * s
    sq = torch.sqrt(lam + reg)
    r_half = torch.sqrt(torch.as_tensor(reg, dtype=c.dtype, device=c.device))
    d_fwd = (sq - r_half)[..., None, :]
    d_inv = (1.0 / sq - 1.0 / r_half)[..., None, :]
    eye = torch.eye(n, dtype=c.dtype, device=c.device)
    vt = v.transpose(-1, -2)
    p_half = (v * d_fwd) @ vt + r_half * eye
    p_inv_half = (v * d_inv) @ vt + eye / r_half
    return p_half, p_inv_half


def _kkt_arrays(xi, y, m_act, b_act, a_t, l, u, act_u, act_l, eq):
    ax = qp.mv(a_t, xi)
    viol = torch.clamp(l - ax, min=0.0) + torch.clamp(ax - u, min=0.0)
    zero = torch.zeros_like(y)
    sign = torch.where(act_u & ~eq, torch.clamp(-y, min=0.0), zero) \
        + torch.where(act_l & ~eq, torch.clamp(y, min=0.0), zero)
    comp = torch.abs(m_act * (ax - b_act)) * torch.abs(y)
    return ax, viol, sign, comp


def solve_factored(prob: FactoredQP, *, admm_iters: int = 100,
                   polish_passes: int = 24, rho: float = 1.0,
                   kkt_tol: float = 1e-5,
                   x0: torch.Tensor | None = None) -> torch.Tensor:
    """Exact minimizer of the factored QP; batch over leading axes.

    x0: optional warm start in the original variables (e.g. the previous
    tick's forces); it is whitened into the ADMM stage, and the polish
    starts from the warm solve's active set."""
    dtype, device = prob.q.dtype, prob.q.device
    n = prob.q.shape[-1]
    mrows = prob.l.shape[-1]
    batch = prob.q.shape[:-1]

    p_half, p_inv_half = whiten_factors(prob.c, prob.reg)

    qt = qp.mv(p_inv_half, prob.q)
    a_t = prob.a @ p_inv_half                           # [..., m, n]
    row_norm = torch.sqrt(torch.sum(a_t * a_t, dim=-1)) + 1e-30
    a_t = a_t / row_norm[..., None]
    l = prob.l / row_norm
    u = prob.u / row_norm

    # Stage 2: whitened ADMM (identity Hessian, unit rows).
    rho_vec = qp.default_rho(l, u, rho=rho)
    eye = torch.eye(n, dtype=dtype, device=device).expand(batch + (n, n))
    xi_warm = None if x0 is None else qp.mv(p_half, x0)
    sol = qp.admm_solve(eye, qt, a_t, l, u, iters=admm_iters, rho=rho_vec,
                        scale=False, x0=xi_warm)
    xi0 = sol.x

    # Stage 3: single-pivot active-set polish.
    eq = (u - l) < 1e-9
    a_tt = a_t.transpose(-1, -2)
    gmat = a_t @ a_tt                                   # [..., m, m] fixed
    ax0 = qp.mv(a_t, xi0)
    scale0 = torch.clamp(torch.amax(torch.abs(ax0), dim=-1, keepdim=True),
                         min=1.0)
    tol0 = 1e-4 * scale0
    act_u = (ax0 > u - tol0) & ~eq
    act_l = (ax0 < l + tol0) & ~eq

    eye_m = torch.eye(mrows, dtype=dtype, device=device)
    rows = torch.arange(mrows, device=device)
    a_qt = qp.mv(a_t, -qt)
    best_kkt = torch.full(batch, float("inf"), dtype=dtype, device=device)
    best_xi = xi0
    for _ in range(polish_passes):
        act = act_l | act_u | eq
        m_act = act.to(dtype)
        b_act = torch.where(act_u, u, l)
        s_mat = m_act[..., :, None] * gmat * m_act[..., None, :] \
            + (1.0 + 1e-9 - m_act)[..., :, None] * eye_m
        s_inv = linalg.inv_spd(s_mat, refine=2)
        rhs = m_act * (a_qt - b_act)
        y = m_act * qp.mv(s_inv, rhs)
        xi = -qt - qp.mv(a_tt, m_act * y)
        ax, viol, sign, comp = _kkt_arrays(xi, y, m_act, b_act, a_t, l, u,
                                           act_u, act_l, eq)
        max_viol = torch.amax(viol, -1)
        max_sign = torch.amax(sign, -1)
        kkt = max_viol + max_sign + torch.amax(comp, -1)
        better = kkt < best_kkt
        best_xi = torch.where(better[..., None], xi, best_xi)
        best_kkt = torch.where(better, kkt, best_kkt)
        # Single pivot per pass, frozen once the KKT residual is tight;
        # argmax takes the first maximum, as jnp.argmax does.
        live = (kkt > kkt_tol)[..., None]
        drop_phase = (max_sign > 1e-7)[..., None]
        one_hot_drop = rows == torch.argmax(sign, dim=-1)[..., None]
        do_drop = live & drop_phase & one_hot_drop
        act_u = act_u & ~do_drop
        act_l = act_l & ~do_drop
        worst_viol = torch.argmax(viol, dim=-1)[..., None]
        one_hot_add = rows == worst_viol
        has_viol = (max_viol > 1e-7)[..., None]
        do_add = live & ~drop_phase & has_viol & one_hot_add
        above = torch.gather(ax, -1, worst_viol) > torch.gather(u, -1,
                                                               worst_viol)
        act_u = act_u | (do_add & above & ~eq)
        act_l = act_l | (do_add & ~above & ~eq)

    return qp.mv(p_inv_half, best_xi)
