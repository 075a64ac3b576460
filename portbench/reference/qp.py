"""Batched dense QP solver, ADMM with OSQP-style splitting (a frozen copy of the port's twin of quadruped_tpu/solvers/qp.py).

Problem form:   min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u
Equalities are rows with l == u. Operands carry any leading batch axes.

One inverse per solve, M = P + sigma I + A^T diag(rho) A (the block-Schur
`inv_spd` with two Newton steps), then a fixed number of ADMM iterations,
each a mat-vec and a clip: the JAX `lax.scan` becomes a Python loop of
plain torch ops. Per-row rho (higher on equality rows), over-relaxation
alpha = 1.6, optional Ruiz equilibration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import linalg

DEFAULT_SIGMA = 1e-6
DEFAULT_ALPHA = 1.6
EQ_RHO_SCALE = 1e3
RUIZ_ITERS = 10
BIG_BOUND = 1e7


class QPSolution(NamedTuple):
    x: torch.Tensor          # [..., n] primal solution
    z: torch.Tensor          # [..., m] constraint values (projected)
    y: torch.Tensor          # [..., m] dual solution
    prim_res: torch.Tensor   # [...] final primal residual (inf-norm)
    dual_res: torch.Tensor   # [...] final dual residual (inf-norm)


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: [..., r, c] @ [..., c] -> [..., r]."""
    return torch.einsum("...rc,...c->...r", m, v)


def default_rho(l: torch.Tensor, u: torch.Tensor,
                rho: float = 0.1) -> torch.Tensor:
    """Per-row rho: `rho` for inequalities, EQ_RHO_SCALE*rho for equalities."""
    is_eq = (u - l) < 1e-9
    return torch.where(is_eq, rho * EQ_RHO_SCALE, rho).to(l.dtype)


def ruiz_equilibrate(p, q, a, l, u, iters: int = RUIZ_ITERS):
    """Symmetric Ruiz equilibration of the KKT data (OSQP 'scaling').

    Returns (p', q', a', l', u', d, e, c): x = d * x', y = e * y' / c.
    Infinite bounds are preserved."""
    n = p.shape[-1]
    m = a.shape[-2]
    d = torch.ones(p.shape[:-2] + (n,), dtype=p.dtype, device=p.device)
    e = torch.ones(a.shape[:-2] + (m,), dtype=p.dtype, device=p.device)
    c = torch.ones(p.shape[:-2], dtype=p.dtype, device=p.device)
    ps, qs, as_ = p, q, a

    def safe_inv_sqrt(x):
        # Zero rows/columns (masked-out constraints) keep scale 1.
        return torch.where(x > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(x, 1e-12, 1e12)),
                           torch.ones_like(x))

    for _ in range(iters):
        col_p = torch.amax(torch.abs(ps), dim=-2)
        col_a = torch.amax(torch.abs(as_), dim=-2)
        dd = safe_inv_sqrt(torch.maximum(col_p, col_a))
        row_a = torch.amax(torch.abs(as_), dim=-1)
        ee = safe_inv_sqrt(row_a)
        ps = dd[..., :, None] * ps * dd[..., None, :]
        qs = qs * dd
        as_ = ee[..., :, None] * as_ * dd[..., None, :]
        d = d * dd
        e = e * ee
        # Cost normalization: mean column norm of P' and norm of q'.
        gamma = 1.0 / torch.clamp(
            torch.maximum(torch.mean(torch.amax(torch.abs(ps), dim=-2),
                                     dim=-1),
                          torch.amax(torch.abs(qs), dim=-1)), 1e-8, 1e8)
        ps = ps * gamma[..., None, None]
        qs = qs * gamma[..., None]
        c = c * gamma

    ls = torch.where(l <= -BIG_BOUND, l, e * l)
    us = torch.where(u >= BIG_BOUND, u, e * u)
    return ps, qs, as_, ls, us, d, e, c


def admm_solve(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
               l: torch.Tensor, u: torch.Tensor, *,
               rho: torch.Tensor | float | None = None,
               sigma: float = DEFAULT_SIGMA, alpha: float = DEFAULT_ALPHA,
               iters: int = 60, x0: torch.Tensor | None = None,
               y0: torch.Tensor | None = None,
               scale: bool = True) -> QPSolution:
    """Solve a batch of dense QPs with a fixed ADMM iteration budget.

    Warm start through (x0, y0). With scale=True the data is
    Ruiz-equilibrated first; residuals are reported in the original
    (unscaled) problem."""
    if scale:
        p0_, q0_, a0_, l0_, u0_ = p, q, a, l, u
        p, q, a, l, u, d_s, e_s, c_s = ruiz_equilibrate(p, q, a, l, u)
        if x0 is not None:
            x0 = x0 / d_s
        if y0 is not None:
            y0 = y0 * c_s[..., None] / e_s

    n = p.shape[-1]
    if rho is None:
        rho_vec = default_rho(l, u)
    else:
        rho_vec = torch.broadcast_to(
            torch.as_tensor(rho, dtype=p.dtype, device=p.device), l.shape)
    rho_inv = 1.0 / rho_vec

    at = a.transpose(-1, -2)
    m_mat = (p + sigma * torch.eye(n, dtype=p.dtype, device=p.device)
             + at @ (rho_vec[..., :, None] * a))
    # Two Newton steps: M carries 1000x-rho equality rows, and its inverse
    # error shifts the ADMM fixed point 1:1.
    m_inv = linalg.inv_spd(m_mat, refine=2)

    x = torch.zeros_like(q) if x0 is None else x0
    z = torch.clamp(mv(a, x), l, u)
    y = torch.zeros_like(l) if y0 is None else y0

    for _ in range(iters):
        rhs = sigma * x - q + mv(at, rho_vec * z - y)
        x_t = mv(m_inv, rhs)
        z_t = mv(a, x_t)
        x_new = alpha * x_t + (1 - alpha) * x
        z_relaxed = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_relaxed + rho_inv * y, l, u)
        y = y + rho_vec * (z_relaxed - z_new)
        x, z = x_new, z_new

    if scale:
        # Unscale: x = D x', y = E y' / c.
        x = x * d_s
        y = y * e_s / c_s[..., None]
        p, q, a, l, u = p0_, q0_, a0_, l0_, u0_
        z = torch.clamp(mv(a, x), l, u)
        at = a.transpose(-1, -2)

    ax = mv(a, x)
    prim = torch.amax(torch.abs(ax - torch.clamp(ax, l, u)), dim=-1)
    dual_vec = mv(p.transpose(-1, -2), x) + q + mv(at, y)
    dual = torch.amax(torch.abs(dual_vec), dim=-1)
    return QPSolution(x=x, z=z, y=y, prim_res=prim, dual_res=dual)


