"""SE(3)/SO(3) math on batched torch tensors (a frozen copy of the port's twin of quadruped_tpu/core/se3.py).

Only what the advanced-trot rollout, the force-balance stance controller,
the whole-body model, the WBC and the walk's pose planner reach is ported. Conventions match
the JAX module: quaternions (w, x, y, z), RPY stored as (roll, pitch, yaw)
with `rpy_to_rotmat(rpy) = Rz(yaw) Ry(pitch) Rx(roll)` body -> world. Every
function broadcasts over leading axes.
"""

from __future__ import annotations

import math

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix: skew(v) @ u == v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    co_d = f * g - d * i
    co_e = a * i - c * g
    co_f = c * d - a * f
    co_g = d * h - e * g
    co_h = b * g - a * h
    co_i = a * e - b * d
    det = a * co_a + b * co_d + c * co_g
    rows = [
        torch.stack([co_a, co_b, co_c], dim=-1),
        torch.stack([co_d, co_e, co_f], dim=-1),
        torch.stack([co_g, co_h, co_i], dim=-1),
    ]
    return torch.stack(rows, dim=-2) / det[..., None, None]


def rot_x(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, c, -s], dim=-1),
        torch.stack([zero, s, c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [
        torch.stack([c, zero, s], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([-s, zero, c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of small matrices as broadcast-multiply-reduce (the
    JAX module's arithmetic, kept so the parity tests compare like with
    like)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def rpy_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] (roll, pitch, yaw) -> [..., 3, 3] body->world rotation."""
    cr, sr = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cp, sp = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cy, sy = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    rows = [
        torch.stack([cy * cp, cy * sp * sr - sy * cr,
                     cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr,
                     sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) unit quaternion -> [..., 3, 3] rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3] (roll, pitch, yaw)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(2 * (w * y - x * z), -1.0, 1.0)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(as_)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4] (w, x, y, z)."""
    half = rpy * 0.5
    cr, cp, cy = (torch.cos(half[..., i]) for i in range(3))
    sr, sp, sy = (torch.sin(half[..., i]) for i in range(3))
    return torch.stack([cr * cp * cy + sr * sp * sy,
                        sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.as_tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                               device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 3] vector(s) by quaternion(s) q (body->world)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_error_so3(q_des: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Orientation error as a body-frame rotation vector:
    log(R(q)^T R(q_des))."""
    dq = quat_mul(quat_conj(q), q_des)
    dq = dq * torch.where(dq[..., :1] < 0, -1.0, 1.0)
    # For unit dq = (cos h, u sin h): log = 2 h u.
    s = torch.linalg.vector_norm(dq[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(s[..., 0], dq[..., 0])[..., None]
    axis = dq[..., 1:] / torch.clamp(s, min=1e-12)
    return torch.where(s > 1e-12, 2.0 * half * axis, torch.zeros_like(axis))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, broadcasting."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate body-frame angular velocity over dt: q' = q * exp(omega dt/2)."""
    angle = torch.linalg.vector_norm(omega, dim=-1, keepdim=True) * dt
    half = angle * 0.5
    axis_sin = omega * dt * 0.5 * torch.where(
        angle > 1e-8, torch.sin(half) / torch.clamp(half, min=1e-12),
        torch.ones_like(half))
    dq = torch.cat([torch.cos(half), axis_sin], dim=-1)
    out = quat_mul(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.round(a / (2.0 * math.pi))
