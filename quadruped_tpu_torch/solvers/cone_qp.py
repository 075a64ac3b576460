"""Batched friction-cone QP solver for the MPC (port of quadruped_tpu/solvers/cone_qp.py).

Same scheme as the JAX `solve`: per-triple scalar equilibration with cost
normalization, per-row rho with a 100x boost on pinned fz rows,
M = gamma d P d + sigma I + blockdiag(A^T rho A), a mixed-precision
Newton-Schulz inverse of M (plain `torch.matmul`, as the JAX package leaves
it to XLA outside any kernel), then the ADMM loop. The loop is the
`fused_admm` kernel (solvers/fused_admm.py): the JAX package's `solve` and
`solve_fused` compute the same thing, so the port has one function, the
closed loop's solver. `solve_fused_full` hands M itself to the
`fused_full_solve` kernel, which inverts it and runs the loop on chip.

Batch-first: `ConeQP.p` is [B, n, n] with n = 3T, `mu` is [B].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quadruped_tpu_torch.solvers.fused_admm import fused_admm
from quadruped_tpu_torch.solvers.fused_full_solve import fused_full_solve

SIGMA = 1e-6
ALPHA = 1.6
RHO_CONE = 0.05
NS_ITERS = 11
BIG = 1e8


@dataclasses.dataclass
class ConeQP:
    """min 1/2 x^T P x + q^T x  s.t. per-triple cones on x.reshape(T, 3):
    4 pyramid rows >= 0 and fz in [fz_lo[t], fz_hi[t]]."""

    p: torch.Tensor       # [B, n, n], n = 3T
    q: torch.Tensor       # [B, n]
    mu: torch.Tensor      # [B] friction coefficient
    fz_lo: torch.Tensor   # [B, T]
    fz_hi: torch.Tensor   # [B, T]


@dataclasses.dataclass
class ConeSolution:
    x: torch.Tensor         # [B, n]
    y: torch.Tensor         # [B, T, 5] duals
    prim_res: torch.Tensor  # [B]


class AdmmInputs(NamedTuple):
    """The scaled problem as the ADMM kernel takes it, plus the scales."""

    m_inv: torch.Tensor   # [B, n, n] (None from `admm_operands`)
    q: torch.Tensor       # [B, n]
    mu: torch.Tensor      # [B]
    lo: torch.Tensor      # [B, 5T]
    hi: torch.Tensor      # [B, 5T]
    rho: torch.Tensor     # [B, 5T]
    x0: torch.Tensor      # [B, n]
    y0: torch.Tensor      # [B, 5T]
    d: torch.Tensor       # [B, n] variable scaling
    gamma: torch.Tensor   # [B] cost normalization


def cone_pattern(mu: torch.Tensor) -> torch.Tensor:
    """[..., 5, 3] rows: [fx+mu fz, -fx+mu fz, fy+mu fz, -fy+mu fz, fz]."""
    zero = torch.zeros_like(mu)
    one = torch.ones_like(mu)
    rows = [
        torch.stack([one, zero, mu], dim=-1),
        torch.stack([-one, zero, mu], dim=-1),
        torch.stack([zero, one, mu], dim=-1),
        torch.stack([zero, -one, mu], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def newton_schulz_inverse(m: torch.Tensor, iters: int = NS_ITERS,
                          f32_polish: int = 2) -> torch.Tensor:
    """Batched SPD inverse by Newton-Schulz, X <- X (2I - M X), X0 = I/||M||_inf.

    All but the last `f32_polish` steps carry X in bf16 and take float32
    products of the bf16 operands before the subtraction (the JAX code's
    preferred_element_type=float32); the polish steps run in full float32.
    Callers on the card keep TF32 off, so the float32 products are exact
    products of the bf16 values.
    """
    n = m.shape[-1]
    norminf = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    eye2 = 2.0 * torch.eye(n, dtype=m.dtype, device=m.device)
    n_bf = max(iters - f32_polish, 0)
    x_bf = (torch.eye(n, dtype=torch.bfloat16, device=m.device)
            / norminf.to(torch.bfloat16)[..., None, None])
    if n_bf > 0:
        m_bf = m.to(torch.bfloat16).to(m.dtype)
        for _ in range(n_bf):
            xf = x_bf.to(m.dtype)
            inner = eye2 - torch.matmul(m_bf, xf)
            x_bf = torch.matmul(
                xf, inner.to(torch.bfloat16).to(m.dtype)).to(torch.bfloat16)
    x = x_bf.to(m.dtype)
    for _ in range(iters - n_bf):
        x = torch.matmul(x, eye2 - torch.matmul(m, x))
    return x


def _project(z: torch.Tensor, fz_lo: torch.Tensor, fz_hi: torch.Tensor,
             big: float = BIG) -> torch.Tensor:
    """Clip [., T, 5] constraint values: pyramid rows to [0, big], fz row to
    [fz_lo, fz_hi]."""
    lo = torch.cat([torch.zeros_like(z[..., :4]), fz_lo[..., None]], dim=-1)
    hi = torch.cat([torch.full_like(z[..., :4], big), fz_hi[..., None]],
                   dim=-1)
    return torch.clamp(z, lo, hi)


def _equilibrate_scales(prob: ConeQP):
    """Per-triple scaling + cost normalization (scales only)."""
    n = prob.p.shape[-1]
    t = n // 3
    batch = prob.p.shape[:-2]
    abs_p = torch.abs(prob.p)
    col_norm = torch.amax(abs_p, dim=-2)
    trip_norm = torch.amax(col_norm.reshape(batch + (t, 3)), dim=-1)
    d_t = torch.where(trip_norm > 1e-12, 1.0 / torch.sqrt(trip_norm),
                      torch.ones_like(trip_norm))
    d = torch.repeat_interleave(d_t, 3, dim=-1)
    wcol = torch.amax(d[..., :, None] * abs_p, dim=-2) * d
    q_d = prob.q * d
    gamma = 1.0 / torch.clamp(
        torch.maximum(torch.mean(wcol, dim=-1),
                      torch.amax(torch.abs(q_d), dim=-1)), 1e-12, 1e12)
    q_s = q_d * gamma[..., None]
    return q_s, d, d_t, gamma, prob.fz_lo / d_t, prob.fz_hi / d_t


def admm_operands(prob: ConeQP, rho: float, sigma: float,
                  x0: torch.Tensor | None, y0: torch.Tensor | None):
    """Equilibrate, build M = gamma d P d + sigma I + blockdiag(A^T rho A)
    and lay the problem out as the ADMM kernels take it (warm start scaled
    in). Returns (M [B, n, n], AdmmInputs with m_inv None)."""
    b, n, _ = prob.p.shape
    t = n // 3
    dtype, device = prob.p.dtype, prob.p.device
    q_s, d, d_t, gamma, fz_lo, fz_hi = _equilibrate_scales(prob)
    mu = prob.mu.expand(b).contiguous()
    pattern = cone_pattern(mu)                                  # [B, 5, 3]

    # Per-row rho: swing-pinned triples (fz_hi ~ fz_lo) get 100x rho on
    # their fz row (OSQP-style near-equality rows).
    pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]                # [B, T, 1]
    row_template = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                                device=device)
    rho_rows = rho * (1.0 + 99.0 * pinned * row_template)       # [B, T, 5]
    ata = torch.einsum("bir,btr,brj->btij", pattern.transpose(-1, -2),
                       rho_rows, pattern)
    eye_t = torch.eye(t, dtype=dtype, device=device)
    scale = gamma[:, None, None] * d[:, :, None] * d[:, None, :]
    m_mat = scale * prob.p + sigma * torch.eye(n, dtype=dtype, device=device) \
        + torch.einsum("btij,tu->btiuj", ata, eye_t).reshape(b, n, n)

    zeros4 = torch.zeros(b, t, 4, dtype=dtype, device=device)
    lo = torch.cat([zeros4, fz_lo[..., None]], dim=-1).reshape(b, 5 * t)
    hi = torch.cat([zeros4 + BIG, fz_hi[..., None]], dim=-1).reshape(b, 5 * t)
    x_init = torch.zeros_like(q_s) if x0 is None else x0 / d
    y_init = (torch.zeros(b, 5 * t, dtype=dtype, device=device) if y0 is None
              else (y0 * gamma[:, None, None]).reshape(b, 5 * t))
    return m_mat, AdmmInputs(m_inv=None, q=q_s, mu=mu, lo=lo, hi=hi,
                             rho=rho_rows.reshape(b, 5 * t).contiguous(),
                             x0=x_init, y0=y_init, d=d, gamma=gamma)


def admm_inputs(prob: ConeQP, *, rho: float = RHO_CONE, sigma: float = SIGMA,
                x0: torch.Tensor | None = None,
                y0: torch.Tensor | None = None, ns_iters: int = NS_ITERS,
                ns_f32_polish: int = 1) -> AdmmInputs:
    """Equilibrate, build M and its Newton-Schulz inverse, and lay the
    problem out as the ADMM kernel takes it (warm start scaled in)."""
    m_mat, inp = admm_operands(prob, rho, sigma, x0, y0)
    return inp._replace(
        m_inv=newton_schulz_inverse(m_mat, ns_iters, ns_f32_polish))


def _unscale(prob: ConeQP, inp: AdmmInputs, x_s: torch.Tensor,
             y_s: torch.Tensor) -> ConeSolution:
    """Scaled iterates -> solution in the problem's units, with the primal
    residual of the unscaled cone constraints."""
    b, n = x_s.shape
    t = n // 3
    x_out = x_s * inp.d
    y_out = y_s.reshape(b, t, 5) / inp.gamma[:, None, None]
    ax = torch.einsum("bri,bti->btr", cone_pattern(inp.mu),
                      x_out.reshape(b, t, 3))
    ax_proj = _project(ax, prob.fz_lo, prob.fz_hi)
    prim = torch.amax(torch.abs(ax - ax_proj), dim=(-2, -1))
    return ConeSolution(x=x_out, y=y_out, prim_res=prim)


def shift_warm_start(x: torch.Tensor, y: torch.Tensor,
                     pin_prev: torch.Tensor, pin_new: torch.Tensor,
                     n_legs: int = 4):
    """Flip-aware warm start: per scenario, the previous solution shifted
    one horizon step forward (tail duplicated) when the contact table
    advanced between cadence solves, else the solution in place.

    The shifted start is taken when at least one full leg set flipped
    (n_flip >= n_legs) and the new pin pattern matches the shifted previous
    one strictly better. Only meaningful for unblocked horizons.
    x: [B, 12H], y: [B, 4H, 5], pin_*: [B, 4H]; returns (x0, y0).
    """
    b = x.shape[0]
    h = pin_prev.shape[-1] // n_legs

    def shift(v, steps_shape):
        s = v.reshape((b, h) + steps_shape)
        return torch.cat([s[:, 1:], s[:, -1:]], dim=1).reshape(v.shape)

    x_shift = shift(x, (3 * n_legs,))
    y_shift = shift(y, (n_legs, y.shape[-1]))
    pin_sh = shift(pin_prev, (n_legs,))
    n_flip = torch.sum(pin_new != pin_prev, dim=-1)
    n_flip_sh = torch.sum(pin_new != pin_sh, dim=-1)
    use = (n_flip >= n_legs) & (n_flip_sh < n_flip)
    return (torch.where(use[:, None], x_shift, x),
            torch.where(use[:, None, None], y_shift, y))


def solve_fused_full(prob: ConeQP, *, iters: int = 40, rho: float = RHO_CONE,
                     sigma: float = SIGMA, alpha: float = ALPHA,
                     x0: torch.Tensor | None = None,
                     y0: torch.Tensor | None = None,
                     ns_iters: int = NS_ITERS, ns_f32_polish: int = 1,
                     accel_restart: int = 0) -> ConeSolution:
    """`solve` with the Newton-Schulz inverse and the ADMM loop in one
    kernel (solvers/fused_full_solve.py): the equilibration, M and the
    per-row rho are `solve`'s, M goes to the kernel uninverted. The
    kernel's inverse follows the Pallas kernel's rounding schedule
    (`fused_full_solve.newton_schulz_reference`). Raises ValueError when n
    is too large for one block's shared memory (n > 132)."""
    m_mat, inp = admm_operands(prob, rho, sigma, x0, y0)
    x_s, y_s = fused_full_solve(
        m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0,
        ns_iters=ns_iters, ns_f32_polish=ns_f32_polish, iters=iters,
        sigma=sigma, alpha=alpha, accel_restart=accel_restart)
    return _unscale(prob, inp, x_s, y_s)


def solve(prob: ConeQP, *, iters: int = 40, rho: float = RHO_CONE,
          sigma: float = SIGMA, alpha: float = ALPHA,
          x0: torch.Tensor | None = None, y0: torch.Tensor | None = None,
          ns_iters: int = NS_ITERS, ns_f32_polish: int = 1,
          bf16_iters: int = 0, accel_restart: int = 0,
          inv_carry=None, return_inv_carry: bool = False) -> ConeSolution:
    """Fixed-budget ADMM on the cone QP, batch [B] first.

    accel_restart > 0 is Fast-ADMM (Nesterov momentum on (z, y) restarted
    every accel_restart iterations; pass alpha=1.0 with it). The bf16 loop
    (`bf16_iters`) and the cross-cadence inverse carry (`inv_carry`,
    `return_inv_carry`) are not ported yet.
    """
    if bf16_iters > 0 or inv_carry is not None or return_inv_carry:
        raise NotImplementedError(
            "bf16_iters, inv_carry and return_inv_carry are not ported")
    inp = admm_inputs(prob, rho=rho, sigma=sigma, x0=x0, y0=y0,
                      ns_iters=ns_iters, ns_f32_polish=ns_f32_polish)
    x_s, y_s = fused_admm(inp.m_inv, inp.q, inp.mu, inp.lo, inp.hi, inp.rho,
                          inp.x0, inp.y0, iters=iters, sigma=sigma,
                          alpha=alpha, accel_restart=accel_restart)
    return _unscale(prob, inp, x_s, y_s)
