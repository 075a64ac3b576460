"""The optional 18-state Kalman filter of the CMU/A1 lineage: base
position and velocity plus the four foot positions, all in the world
frame (port of quadruped_tpu/estimation/cmu_kf.py; off by default, as in
the JAX package).

State x = [p(3), v(3), p_foot(4 x 3)]. The base is driven by the IMU's
specific force, the feet are random walks whose noise is gated by a
contact probability from the foot force. The 28 measurements are the
feet relative to the base from leg kinematics (12), the base velocity
from each stance leg (12) and the stance feet's height z = 0 (4); swing
legs observe the filter's own prediction. One [28, 28] solve a tick, by
`torch.linalg.solve` (the JAX module's `jnp.linalg.solve`; no kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams

NX = 18
NZ = 28
_GRAV = (0.0, 0.0, -9.81)

# Noise constants of the reference's CMU parameters.
PROCESS_NOISE_PIMU = 0.01
PROCESS_NOISE_VIMU = 0.01
PROCESS_NOISE_PFOOT = 0.01
SENSOR_NOISE_PIMU_REL_FOOT = 0.001
SENSOR_NOISE_VIMU_REL_FOOT = 0.1
SENSOR_NOISE_ZFOOT = 0.001
SWING_GATE = 1e3  # variance multiplier on non-contact legs


def _build_c() -> np.ndarray:
    """The static [28, 18] observation matrix."""
    c = np.zeros((NZ, NX), np.float32)
    eye3 = np.eye(3, dtype=np.float32)
    for i in range(4):
        c[i * 3:i * 3 + 3, 0:3] = -eye3
        c[i * 3:i * 3 + 3, 6 + i * 3:9 + i * 3] = eye3
        c[12 + i * 3:15 + i * 3, 3:6] = eye3
        c[24 + i, 6 + i * 3 + 2] = 1.0
    return c


_C = _build_c()


@dataclasses.dataclass
class CmuKfConfig:
    assume_flat_ground: bool = True


@dataclasses.dataclass
class CmuKfState:
    x: torch.Tensor    # [B, 18]
    cov: torch.Tensor  # [B, 18, 18]


def contact_probability(foot_force: torch.Tensor) -> torch.Tensor:
    """clip((f + 20) / 100, 0, 1): the force -> contact ramp."""
    return torch.clamp((foot_force + 20.0) * np.float32(0.01), 0.0, 1.0)


def cmu_kf_init(params: RobotParams, *, quat: torch.Tensor,
                joint_angles: torch.Tensor,
                base_height: float = 0.27) -> CmuKfState:
    """The base at (0, 0, h) and the feet from forward kinematics; quat
    [B, 4], joint_angles [B, 12] on the device the state is built on."""
    b, device = quat.shape[0], quat.device
    r = se3.quat_to_rotmat(quat)
    p0 = torch.as_tensor([0.0, 0.0, base_height], dtype=torch.float32,
                         device=device).expand(b, 3)
    feet_base = kinematics.foot_positions_in_base_frame(params, joint_angles)
    feet_world = torch.einsum("bij,blj->bli", r, feet_base) + p0[:, None]
    x = torch.cat([p0, torch.zeros(b, 3, device=device),
                   feet_world.reshape(b, 12)], dim=-1)
    cov = 3.0 * torch.eye(NX, device=device).expand(b, NX, NX)
    return CmuKfState(x=x, cov=cov.clone())


def cmu_kf_update(config: CmuKfConfig, params: RobotParams,
                  state: CmuKfState, *,
                  acc_body: torch.Tensor,          # [B, 3]
                  quat: torch.Tensor,              # [B, 4]
                  omega_body: torch.Tensor,        # [B, 3]
                  joint_angles: torch.Tensor,      # [B, 12]
                  joint_velocities: torch.Tensor,  # [B, 12]
                  foot_force: torch.Tensor,        # [B, 4] vertical (N)
                  dt) -> CmuKfState:
    b, dtype, device = state.x.shape[0], state.x.dtype, state.x.device
    c_mat = torch.as_tensor(_C, device=device)
    eye = torch.eye(NX, dtype=dtype, device=device)
    r = se3.quat_to_rotmat(quat)
    contact = contact_probability(foot_force)
    gate = 1.0 + (1.0 - contact) * SWING_GATE                      # [B, 4]

    # A and B with the live dt; u = R a + g.
    a_mat = eye.clone()
    a_mat[0:3, 3:6] = dt * torch.eye(3, dtype=dtype, device=device)
    u = torch.einsum("bij,bj->bi", r, acc_body) + torch.as_tensor(
        _GRAV, dtype=dtype, device=device)
    xbar = torch.einsum("ij,bj->bi", a_mat, state.x)
    xbar = torch.cat([xbar[:, :3], xbar[:, 3:6] + dt * u, xbar[:, 6:]], -1)

    # Process noise.
    q_diag = torch.cat([
        torch.full((b, 3), PROCESS_NOISE_PIMU * dt / 20.0, dtype=dtype,
                   device=device),
        torch.full((b, 3), PROCESS_NOISE_VIMU * dt * 9.8 / 20.0, dtype=dtype,
                   device=device),
        torch.repeat_interleave(gate * (dt * PROCESS_NOISE_PFOOT), 3, -1)],
        dim=-1)
    cov_bar = a_mat @ state.cov @ a_mat.T + torch.diag_embed(q_diag)

    # Measurements.
    feet_base = kinematics.foot_positions_in_base_frame(params, joint_angles)
    vfeet_base = kinematics.foot_velocities_in_base_frame(
        params, joint_angles, joint_velocities)
    fk_world = torch.einsum("bij,blj->bli", r, feet_base)       # [B, 4, 3]
    leg_v = -vfeet_base - torch.linalg.cross(
        omega_body[:, None, :].expand_as(feet_base), feet_base)
    v_kin_world = torch.einsum("bij,blj->bli", r, leg_v)
    # Swing legs observe the prediction itself (no-information residual).
    cl = contact[..., None]
    v_obs = cl * v_kin_world + (1.0 - cl) * xbar[:, None, 3:6]
    z_obs = (1.0 - contact) * (xbar[:, 2:3] + fk_world[..., 2])
    y = torch.cat([fk_world.reshape(b, 12), v_obs.reshape(b, 12), z_obs], -1)

    r_z = (gate * SENSOR_NOISE_ZFOOT if config.assume_flat_ground
           else torch.full((b, 4), 1e5, dtype=dtype, device=device))
    r_diag = torch.cat([
        torch.repeat_interleave(gate * SENSOR_NOISE_PIMU_REL_FOOT, 3, -1),
        torch.repeat_interleave(gate * SENSOR_NOISE_VIMU_REL_FOOT, 3, -1),
        r_z], dim=-1)

    # Kalman update through one solve on the innovation covariance.
    s = c_mat @ cov_bar @ c_mat.T + torch.diag_embed(r_diag)
    s = 0.5 * (s + s.transpose(-1, -2))
    resid = y - torch.einsum("ij,bj->bi", c_mat, xbar)
    pct = cov_bar @ c_mat.T                                       # [B, 18, 28]
    x_new = xbar + torch.einsum(
        "bij,bj->bi", pct, torch.linalg.solve(s, resid))
    cov_new = cov_bar - pct @ torch.linalg.solve(s, c_mat.expand(b, NZ, NX)) \
        @ cov_bar
    cov_new = 0.5 * (cov_new + cov_new.transpose(-1, -2))

    # xy-drift reduction: where the planar-position variance grew,
    # decouple it from the rest and shrink it.
    det_xy = (cov_new[:, 0, 0] * cov_new[:, 1, 1]
              - cov_new[:, 0, 1] * cov_new[:, 1, 0])
    reduce_mask = (det_xy > 1e-6).to(dtype)[:, None, None]
    keep = torch.ones(NX, NX, dtype=dtype, device=device)
    keep[0:2, 2:] = 0.0
    keep[2:, 0:2] = 0.0
    keep[0:2, 0:2] = 0.1
    cov_reduced = cov_new * keep
    cov_new = reduce_mask * cov_reduced + (1.0 - reduce_mask) * cov_new
    return CmuKfState(x=x_new, cov=cov_new)


def base_position(state: CmuKfState) -> torch.Tensor:
    return state.x[..., 0:3]


def base_velocity_world(state: CmuKfState) -> torch.Tensor:
    return state.x[..., 3:6]


def foot_positions_world(state: CmuKfState) -> torch.Tensor:
    return state.x[..., 6:18].reshape(state.x.shape[:-1] + (4, 3))
