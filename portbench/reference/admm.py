"""The MPC cone QP's ADMM loop in plain torch ops.

A frozen copy of the port's plain loop (`fused_admm_reference`), which the
port's K1 kernel (csrc/fused_admm.cu) computes on the card. Layout: n = 3T
variables, m = 5T constraint rows, rows 5t..5t+4 the friction pyramid of
force triple t (fx + mu fz, -fx + mu fz, fy + mu fz, -fy + mu fz, fz).
"""

from __future__ import annotations

import numpy as np
import torch


def _apply_a(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """[B, 3T] -> [B, 5T]: rows of the per-triple pyramid, mu per problem."""
    b, n = x.shape
    fx, fy, fz = x.view(b, n // 3, 3).unbind(-1)
    mfz = mu[:, None] * fz
    return torch.stack([fx + mfz, -fx + mfz, fy + mfz, -fy + mfz, fz],
                       dim=-1).reshape(b, -1)


def _apply_at(w: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """[B, 5T] -> [B, 3T]: A^T w."""
    b, m = w.shape
    w0, w1, w2, w3, w4 = w.view(b, m // 5, 5).unbind(-1)
    return torch.stack([w0 - w1, w2 - w3,
                        mu[:, None] * (w0 + w1 + w2 + w3) + w4],
                       dim=-1).reshape(b, -1)


def admm_loop(m_inv, q, mu, lo, hi, rho, x0, y0, *, iters: int,
              sigma: float, alpha: float, accel_restart: int = 0, z0=None):
    """The kernel's loop in plain torch ops; returns (x [B, n], y [B, m]).

    Same arithmetic as the kernel and as pallas_admm._admm_loop, with the
    mat-vec x_t = M^{-1} rhs of the JAX `solve` (the Pallas kernel
    contracts over its matrix's first index, so it computes this loop when
    it is given M^{-1} transposed); 1/rho is taken once, and
    the momentum schedule (t_k, beta) is float32 per iteration. With
    accel_restart == 0, beta is 0 and (z_hat, y_hat) = (z, y): the relaxed
    scheme. The loop starts from z0 [B, m] where it is given (an iterate
    carried from a loop that ran the first iterations), else from
    clip(A x0, lo, hi).
    """
    rho_inv = 1.0 / rho
    x, y = x0, y0
    z = torch.clamp(_apply_a(x, mu), lo, hi) if z0 is None else z0
    z_hat, y_hat = z, y
    tk = np.float32(1.0)
    for k in range(iters):
        rhs = sigma * x - q + _apply_at(rho * z_hat - y_hat, mu)
        x_t = torch.bmm(rhs[:, None, :], m_inv.transpose(1, 2))[:, 0]
        z_t = _apply_a(x_t, mu)
        x = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z_hat
        z_new = torch.clamp(z_rel + y_hat * rho_inv, lo, hi)
        y_new = y_hat + rho * (z_rel - z_new)
        beta = np.float32(0.0)
        if accel_restart > 0:
            if k % accel_restart == accel_restart - 1:
                tk_next = np.float32(1.0)
            else:
                tk_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
                    np.float32(1.0) + np.float32(4.0) * tk * tk))
                beta = (tk - np.float32(1.0)) / tk_next
            tk = tk_next
        if beta:
            z_hat = z_new + float(beta) * (z_new - z)
            y_hat = y_new + float(beta) * (y_new - y)
        else:
            z_hat, y_hat = z_new, y_new
        z, y = z_new, y_new
    return x, y
