"""Probabilistic contact and slip detection, batched (port of
quadruped_tpu/estimation/contact.py).

A scalar Kalman filter per leg on the contact probability: the gait-phase
prior (erf windows) is the prediction, the mean of three evidence channels
(foot height above the fitted plane, filtered vertical foot speed, foot
force) the observation; a two-level hysteresis latch gives the contact
flag, and stance legs with a large filtered tangential foot speed are
flagged as slipping. `torch.special.erf` stands in for
`jax.scipy.special.erf` (two float32 approximations; their gap is stated
in tests/test_torch_estimation.py). The JAX module divides by constants,
which XLA compiles into products with the float32 reciprocal; the port
multiplies by the same reciprocals, so that the latched flags see the same
float32 numbers.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from quadruped_tpu_torch.core.filters import (MovingWindowState,
                                              moving_window_init,
                                              moving_window_update)
from quadruped_tpu_torch.robots.params import index_own, per_scenario
from quadruped_tpu_torch.utils import card

SIGMA_PHASE = 0.1
SIGMA_PZ = 0.05
TORQUE_MEAN = 20.0   # foot-force midpoint (N) of the force channel
TORQUE_SIGMA = 10.0
THRESH_ENTER = 0.5   # swing -> contact
THRESH_STAY = 0.25   # contact -> swing (hysteresis)
SLIP_THRESH = 0.6
_SQRT2 = np.sqrt(np.float32(2.0))   # jnp.sqrt(2.0)


def _recip(c) -> float:
    """1 / c in float32, as XLA folds a division by the constant c."""
    return float(np.float32(1.0) / np.float32(c))


_INV_PHASE = _recip(np.float32(SIGMA_PHASE) * _SQRT2)
_INV_PZ = _recip(_SQRT2 * np.float32(SIGMA_PZ) / np.float32(2.0))
_INV_FORCE = _recip(_SQRT2 * np.float32(TORQUE_SIGMA))
_INV_VX = _recip(_SQRT2 * np.float32(0.05))
_INV_VY = _recip(_SQRT2 * np.float32(0.05) / np.float32(3.0))
_INV_3 = _recip(3.0)


@dataclasses.dataclass
class ContactDetectionState:
    p_contact: torch.Tensor      # [B, 4] fused posterior
    cov: torch.Tensor            # [B, 4] per-leg scalar variance
    is_contact: torch.Tensor     # [B, 4] latched flag (as float)
    p_slip: torch.Tensor         # [B, 4]
    is_slip: torch.Tensor        # [B, 4]
    foot_v_filter: MovingWindowState  # [B, window, 4, 3]
    last_vz: torch.Tensor        # [B, 4]


def contact_detection_init(batch: int, window: int = 20,
                           device=None) -> ContactDetectionState:
    device = card.resolve(device)
    z4 = torch.zeros(batch, 4, device=device)
    return ContactDetectionState(
        p_contact=torch.ones_like(z4), cov=torch.full_like(z4, 0.1),
        is_contact=torch.ones_like(z4), p_slip=z4, is_slip=z4.clone(),
        foot_v_filter=moving_window_init(batch, window, (4, 3), device),
        last_vz=z4.clone())


erf = torch.special.erf


def phase_prior(normalized_phase: torch.Tensor,
                in_stance: torch.Tensor) -> torch.Tensor:
    """Erf window prior: high through the stance phase, low through swing,
    soft edges of width SIGMA_PHASE."""
    phi = normalized_phase
    stance_k = 0.5 * (erf(phi * _INV_PHASE) + erf((1.0 - phi) * _INV_PHASE))
    swing_k = 0.5 * (2.0 + erf(-phi * _INV_PHASE)
                     + erf((phi - 1.0) * _INV_PHASE))
    return torch.where(in_stance > 0.5, stance_k, swing_k)


def contact_detection_update(
    state: ContactDetectionState,
    *,
    normalized_phase: torch.Tensor,          # [B, 4]
    in_stance: torch.Tensor,                 # [B, 4] desired stance
    foot_height_above_ground: torch.Tensor,  # [B, 4]
    foot_velocities_base: torch.Tensor,      # [B, 4, 3]
    foot_forces: torch.Tensor,               # [B, 4]
    base_v_control: torch.Tensor,            # [B, 3]
    process_var: float = 0.02,
    sensor_var: float = 0.1,
) -> ContactDetectionState:
    # The gait-phase prior is the prediction.
    prior = phase_prior(normalized_phase, in_stance)

    # Height above the fitted plane.
    dz = torch.clamp(foot_height_above_ground, min=0.0)
    ppz = 1.0 - erf(dz * _INV_PZ)

    # Filtered vertical foot speed.
    vfilt_state, v_filt = moving_window_update(state.foot_v_filter,
                                               foot_velocities_base)
    vz = v_filt[..., 2]
    pvz = torch.exp(-5.0 * torch.abs(vz))

    # Force evidence.
    pforce = 0.5 * (1.0 + erf((foot_forces - TORQUE_MEAN) * _INV_FORCE))

    # Scalar KF per leg: predict to the prior, observe the mean of the
    # three channels (equal variances: variance / 3).
    p_pred = prior
    cov_pred = state.cov + process_var
    z = (pforce + pvz + ppz) * _INV_3
    k = cov_pred / (cov_pred + sensor_var / 3.0)
    p_new = torch.clamp(p_pred + k * (z - p_pred), 0.0, 1.0)
    cov_new = (1.0 - k) * cov_pred

    # Hysteresis latch.
    thresh = torch.where(state.is_contact > 0.5, THRESH_STAY, THRESH_ENTER)
    is_contact = (p_new > thresh).to(torch.float32)

    # Slip: tangential foot speed while in contact.
    v_world_foot = v_filt[..., :2] + base_v_control[:, None, :2]
    pvx = 0.5 * (1.0 + erf(v_world_foot[..., 0] * _INV_VX))
    pvy = 0.5 * (1.0 + erf(v_world_foot[..., 1] * _INV_VY))
    p_slip = (0.75 * pvx + 0.25 * pvy) * p_new * is_contact
    is_slip = (p_slip > SLIP_THRESH).to(torch.float32)

    return ContactDetectionState(
        p_contact=p_new, cov=cov_new, is_contact=is_contact, p_slip=p_slip,
        is_slip=is_slip, foot_v_filter=vfilt_state, last_vz=vz)


def external_knee_torque(params, tau: torch.Tensor,
                         ddq: torch.Tensor) -> torch.Tensor:
    """The external torque on each knee from the motor torque minus the
    calf's free dynamics about the knee,
    tau_ext = I'_yy ddq_knee + m_calf g l_calf - tau_knee (I'_yy shifted
    to the knee by the parallel-axis theorem). tau, ddq: [..., 12] ->
    [..., 4] (for a fleet of stacked parameters, [B, 12] -> [B, 4])."""
    m_calf = index_own(params, params.links_mass, 2)
    l_calf = params.lower_length
    iyy = index_own(params, params.links_inertia, (2, 1, 1)) \
        + m_calf * l_calf * l_calf
    iyy, m_calf, l_calf = (per_scenario(params, v, tau.ndim)
                           for v in (iyy, m_calf, l_calf))
    return iyy * ddq[..., 2::3] + m_calf * 9.8 * l_calf - tau[..., 2::3]


def workspace_clip(params, foot_positions_base: torch.Tensor,
                   allowed: torch.Tensor):
    """Clip feet [..., 4, 3] to the box of half-extents `allowed` [3]
    around (default hip xy, -body_height): one scale per foot by the
    smallest axis ratio. Returns (clipped feet, outside mask [..., 4])."""
    offset = params.default_hip_position.clone()
    offset[..., 2] = -per_scenario(params, params.body_height, 2)
    p = foot_positions_base - offset
    ratios = allowed / torch.clamp(torch.abs(p), min=1e-9)
    scale = torch.clamp(torch.amin(ratios, dim=-1), max=1.0)
    outside = (scale < 1.0).to(torch.float32)
    return offset + p * scale[..., None], outside
