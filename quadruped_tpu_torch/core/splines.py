"""Swing-foot curves on batched tensors (port of quadruped_tpu/core/splines.py).

The three swing families the swing controller selects between
(`SwingConfig.spline_type`): parabola, cubic and the 9-point B-spline. Each
takes a normalized phase in [0, 1] and returns (position,
velocity-per-unit-phase), broadcasting over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch


def cubic_hermite(p0, v0, p1, v1, phi):
    """Cubic Hermite on [0,1]: returns (pos, vel_per_unit_phase)."""
    t = phi
    t2 = t * t
    t3 = t2 * t
    pos = ((2 * t3 - 3 * t2 + 1) * p0 + (t3 - 2 * t2 + t) * v0
           + (-2 * t3 + 3 * t2) * p1 + (t3 - t2) * v1)
    vel = ((6 * t2 - 6 * t) * p0 + (3 * t2 - 4 * t + 1) * v0
           + (-6 * t2 + 6 * t) * p1 + (3 * t2 - 2 * t) * v1)
    return pos, vel


def swing_parabola(start, end, max_height, phi):
    """XY linear + Z parabola through (0, z0), (0.5, max(z0,z1)+h), (1, z1).

    start, end: [..., 3]; phi: [...]. Returns (pos [..., 3], vel [..., 3]).
    """
    phi = phi[..., None]
    xy = start[..., :2] + (end[..., :2] - start[..., :2]) * phi
    vxy = end[..., :2] - start[..., :2]
    z0 = start[..., 2:3]
    z1 = end[..., 2:3]
    mid = torch.maximum(z0, z1) + max_height
    t = phi
    l0 = 2 * (t - 0.5) * (t - 1.0)
    l1 = -4 * t * (t - 1.0)
    l2 = 2 * t * (t - 0.5)
    z = l0 * z0 + l1 * mid + l2 * z1
    dz = (4 * t - 3) * z0 + (-8 * t + 4) * mid + (4 * t - 1) * z1
    pos = torch.cat([xy, z], dim=-1)
    vel = torch.cat([vxy.expand(xy.shape), dz], dim=-1)
    return pos, vel


def swing_cubic(start, end, max_height, phi):
    """Cubic XY + two-segment Z swing (zero boundary velocities)."""
    phib = phi[..., None]
    xy, vxy = cubic_hermite(start[..., :2], torch.zeros_like(start[..., :2]),
                            end[..., :2], torch.zeros_like(end[..., :2]), phib)
    z0 = start[..., 2:3]
    z1 = end[..., 2:3]
    zero = torch.zeros_like(z0)
    apex = torch.maximum(z0, z1) + max_height
    t_up = torch.clamp(phib * 2.0, 0.0, 1.0)
    t_dn = torch.clamp(phib * 2.0 - 1.0, 0.0, 1.0)
    z_up, vz_up = cubic_hermite(z0, zero, apex, zero, t_up)
    z_dn, vz_dn = cubic_hermite(apex, zero, z1, zero, t_dn)
    up = phib < 0.5
    z = torch.where(up, z_up, z_dn)
    vz = torch.where(up, vz_up, vz_dn) * 2.0
    return torch.cat([xy, z], dim=-1), torch.cat([vxy, vz], dim=-1)


_NUM_CTRL = 9
_DEGREE = 3
_KNOTS = np.concatenate([
    np.zeros(_DEGREE + 1),
    np.arange(1, _NUM_CTRL - _DEGREE) / (_NUM_CTRL - _DEGREE),
    np.ones(_DEGREE + 1),
])
_CTRL_Z = np.array([0.0, 0.0, 0.35, 0.8, 1.0, 0.8, 0.35, 0.05, 0.0])


def bspline_basis(phi: torch.Tensor) -> torch.Tensor:
    """Dense clamped cubic B-spline basis: [...] -> [..., 9] (Cox-de Boor)."""
    knots = torch.as_tensor(_KNOTS, dtype=phi.dtype, device=phi.device)
    u = torch.clamp(phi, 0.0, 1.0 - 1e-6)[..., None]
    n_knots = knots.shape[0]
    t_lo, t_hi = knots[: n_knots - 1], knots[1:]
    basis = ((u >= t_lo) & (u < t_hi)).to(phi.dtype)
    for d in range(1, _DEGREE + 1):
        m = n_knots - d - 1
        t_i, t_id = knots[:m], knots[d: d + m]
        t_i1, t_id1 = knots[1: m + 1], knots[d + 1: d + m + 1]
        left_den = t_id - t_i
        right_den = t_id1 - t_i1
        left = torch.where(left_den > 1e-9, (u - t_i) / torch.where(
            left_den > 1e-9, left_den, torch.ones_like(left_den)), 0.0)
        right = torch.where(right_den > 1e-9, (t_id1 - u) / torch.where(
            right_den > 1e-9, right_den, torch.ones_like(right_den)), 0.0)
        basis = left * basis[..., :m] + right * basis[..., 1: m + 1]
    return basis


def swing_bspline(start, end, max_height, phi):
    """B-spline swing: XY via the eased basis blend, Z via the 9-point
    template; finite-difference velocity per unit phase."""
    basis = bspline_basis(phi)
    ctrl_z = torch.as_tensor(_CTRL_Z, dtype=basis.dtype, device=basis.device)
    ramp = torch.linspace(0.0, 1.0, _NUM_CTRL, dtype=basis.dtype,
                          device=basis.device)
    sxy = basis @ ramp
    xy = start[..., :2] + (end[..., :2] - start[..., :2]) * sxy[..., None]
    z_rel = basis @ ctrl_z
    z0, z1 = start[..., 2], end[..., 2]
    z = z0 + (z1 - z0) * sxy + max_height * z_rel
    eps = 1e-3
    basis2 = bspline_basis(torch.clamp(phi + eps, 0.0, 1.0))
    sxy2 = basis2 @ ramp
    z_rel2 = basis2 @ ctrl_z
    vxy = (end[..., :2] - start[..., :2]) * ((sxy2 - sxy) / eps)[..., None]
    vz = ((z1 - z0) * (sxy2 - sxy) + max_height * (z_rel2 - z_rel)) / eps
    return (torch.cat([xy, z[..., None]], dim=-1),
            torch.cat([vxy, vz[..., None]], dim=-1))
