"""CoM adjuster for position-mode locomotion, batched (port of quadruped_tpu/planner/com_adjuster.py).

Contact-probability weights per leg from erf windows on the gait phase, a
virtual support polygon blending each foot toward its clockwise and
counter-clockwise neighbours by those weights, and the desired CoM in base
frame as the polygon's centroid.

Leg adjacency (leg order FR FL RR RL):
  FR: cw=FL, ccw=RR;  FL: cw=RL, ccw=FR;  RR: cw=FR, ccw=RL;  RL: cw=RR, ccw=FL
"""

from __future__ import annotations

import math

import torch

from quadruped_tpu_torch.gait.scheduler import GaitState, LegState

DELTA = 0.1
CW = [1, 3, 0, 2]    # clockwise neighbour per leg
CCW = [2, 0, 3, 1]   # counter-clockwise neighbour per leg


def contact_weights(gait_state: GaitState) -> torch.Tensor:
    """[B, 4] erf-window contact probability."""
    phi = gait_state.normalized_phase
    s = DELTA * math.sqrt(2.0)
    stance_like = ((gait_state.leg_state == LegState.STANCE)
                   | (gait_state.leg_state == LegState.LOSE_CONTACT))
    erf = torch.special.erf
    contact_k = 0.5 * (erf(phi / s) + erf((1.0 - phi) / s))
    swing_k = 0.5 * (2.0 + erf(-phi / s) + erf((phi - 1.0) / s))
    return torch.where(stance_like, contact_k, swing_k)


def com_position_in_base_frame(gait_state: GaitState,
                               foot_positions_base: torch.Tensor
                               ) -> torch.Tensor:
    """[B, 3] desired CoM shift, base frame; feet [B, 4, 3]."""
    w = contact_weights(gait_state)                  # [B, 4]
    p = foot_positions_base
    p_cw, p_ccw = p[..., CW, :], p[..., CCW, :]
    w_cw, w_ccw = w[..., CW], w[..., CCW]
    phi = w[..., None]
    # Virtual points blend each foot toward its neighbours by its own weight.
    v_cw = phi * p + (1 - phi) * p_cw
    v_ccw = phi * p + (1 - phi) * p_ccw
    denom = (w + w_cw + w_ccw)[..., None]
    vertices = (phi * p + w_ccw[..., None] * v_ccw
                + w_cw[..., None] * v_cw) / torch.clamp(denom, min=1e-6)
    return torch.mean(vertices, dim=-2)
