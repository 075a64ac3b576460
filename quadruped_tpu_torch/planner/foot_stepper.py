"""Terrain-constrained foothold adjustment (gaps and stairs), batched (port of quadruped_tpu/planner/foot_stepper.py).

Each function takes the scenario axis first: footholds [B, 4] (x) or
[B, 4, 3]. Terrain parameters (gap centres, stair geometry) are shared by
the batch (numbers, or [G] centres) or per scenario ([B] numbers, [B, G]
centres). The 1-D foothold-offset QP of the reference is a search over a
static grid of candidate offsets, evaluated in parallel, as in the JAX
module.
"""

from __future__ import annotations

import dataclasses

import torch

# Candidate x-offsets the stepper may add to the nominal step (m): the
# float32 values of the JAX module's jnp.linspace(-0.15, 0.15, 61) on the
# CPU, which rounds otherwise than torch.linspace; the tie between the +x
# and -x candidates of least magnitude goes by their last bits.
CANDIDATES = (
    -0.15, -0.14500001, -0.14, -0.13499999, -0.13, -0.125, -0.120000005,
    -0.11500001, -0.11000001, -0.10500001, -0.1, -0.095, -0.089999996,
    -0.085, -0.08, -0.075, -0.07000001, -0.065, -0.060000002,
    -0.054999996, -0.049999997, -0.045, -0.040000003, -0.034999996,
    -0.029999992, -0.024999995, -0.019999988, -0.014999991,
    -0.009999993, -0.004999995, 2.3283064e-09, 0.0050000073,
    0.010000005, 0.015000003, 0.020000009, 0.02500001, 0.030000009,
    0.035000004, 0.04000001, 0.04500001, 0.050000004, 0.055000015,
    0.060000014, 0.06500001, 0.07000001, 0.07500001, 0.08000001,
    0.08500001, 0.09000002, 0.09500001, 0.10000002, 0.10500001,
    0.11000002, 0.11500002, 0.12000001, 0.12500001, 0.13000003,
    0.13500002, 0.14000002, 0.14500003, 0.15)
# Same-end partner leg of each leg (FR-FL, RR-RL).
PAIR = (1, 0, 3, 2)


def candidate_offsets(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(CANDIDATES, dtype=like.dtype, device=like.device)


def _per_scenario(value, x: torch.Tensor, trailing: int = 0):
    """A terrain parameter that broadcasts against x [B, ...]: a [B] (or
    [B, G] with trailing=1) tensor gets unit axes after the batch axis."""
    if not torch.is_tensor(value) or value.ndim <= trailing:
        return value
    extra = x.ndim - (value.ndim - trailing)
    return value.reshape(value.shape[:value.ndim - trailing] + (1,) * extra
                         + value.shape[value.ndim - trailing:])


def _half_width(gap_width, x: torch.Tensor, margin: float):
    """gap_width / 2 + margin, broadcasting against [B, ..., G]."""
    w = _per_scenario(gap_width, x)
    return (w[..., None] if torch.is_tensor(w) else w) / 2 + margin


def _centers(gap_centers, x: torch.Tensor) -> torch.Tensor:
    return _per_scenario(torch.as_tensor(gap_centers, dtype=x.dtype,
                                         device=x.device), x, 1)


def gap_infeasible(x: torch.Tensor, gap_centers, gap_width) -> torch.Tensor:
    """[B, ...] True where world-x lands inside a gap strip (2 cm margin)."""
    d = torch.abs(x[..., None] - _centers(gap_centers, x))
    return torch.any(d < _half_width(gap_width, x, 0.02), dim=-1)


def optimal_foothold_offset(nominal_x: torch.Tensor, gap_centers,
                            gap_width) -> torch.Tensor:
    """[B]: the common x-offset of least magnitude that moves every one of
    the 4 footholds out of the gaps (0 when none does)."""
    cand = candidate_offsets(nominal_x)
    shifted = nominal_x[:, None, :] + cand[:, None]         # [B, C, 4]
    bad = gap_infeasible(shifted, gap_centers, gap_width)
    feasible = ~torch.any(bad, dim=-1)                      # [B, C]
    cost = torch.where(feasible, torch.abs(cand),
                       torch.full_like(shifted[..., 0], float("inf")))
    best = torch.argmin(cost, dim=-1)
    return torch.where(torch.isfinite(cost.gather(-1, best[:, None])[:, 0]),
                       cand[best], torch.zeros_like(cand[best]))


def snap_to_stairs(foothold_world: torch.Tensor, step_length, step_height,
                   start_x) -> torch.Tensor:
    """Foothold heights snapped to the tread under each x, and x nudged
    away from a tread's rising edge. foothold_world [..., 4, 3]."""
    x = foothold_world[..., 0]
    rel = torch.clamp(x - start_x, min=0.0)
    tread = torch.floor(rel / step_length)
    z = tread * step_height
    frac = rel - tread * step_length
    near_edge = (frac > step_length - 0.03) & (x > start_x)
    x_adj = torch.where(near_edge, x - (frac - (step_length - 0.03)), x)
    return torch.stack([x_adj, foothold_world[..., 1], z], dim=-1)


def adjust_footholds_for_gaps(foothold_world: torch.Tensor, gap_centers,
                              gap_width) -> torch.Tensor:
    """[B, 4, 3] footholds shifted in x by the common offset."""
    off = optimal_foothold_offset(foothold_world[..., 0], gap_centers,
                                  gap_width)
    return torch.cat([foothold_world[..., :1] + off[:, None, None],
                      foothold_world[..., 1:]], dim=-1)


def plan_step_sequence(current_x: torch.Tensor, gap_centers, gap_width,
                       default_delta: float = 0.1, n_steps: int = 3):
    """The next `n_steps` step offsets across a gap field: each step the
    forward-moving common offset of least magnitude, or the cross-gait
    half step (FR and RL advance by delta/2) when none clears the gaps.
    current_x [B, 4]. Returns (offsets [B, n_steps, 4], planned_x [B,
    n_steps, 4])."""
    cand = candidate_offsets(current_x)
    half = torch.as_tensor([0.5, 1.0, 1.0, 0.5], dtype=current_x.dtype,
                           device=current_x.device) * default_delta
    x, offsets, xs = current_x, [], []
    for _ in range(n_steps):
        shifted = (x + default_delta)[:, None, :] + cand[:, None]
        bad = gap_infeasible(shifted, gap_centers, gap_width)
        valid = ~torch.any(bad, dim=-1) & (default_delta + cand > 0.001)
        cost = torch.where(valid, torch.abs(cand),
                           torch.full_like(shifted[..., 0], float("inf")))
        best = torch.argmin(cost, dim=-1)
        full_ok = torch.isfinite(cost.gather(-1, best[:, None])[:, 0])
        full_offset = torch.where(full_ok, cand[best],
                                  torch.zeros_like(cand[best])) \
            + default_delta
        off = torch.where(full_ok[:, None], full_offset[:, None].expand(-1, 4),
                          half)
        x = x + off
        offsets.append(off)
        xs.append(x)
    return torch.stack(offsets, 1), torch.stack(xs, 1)


@dataclasses.dataclass
class StairParams:
    """Uniform staircase: each field [] (shared) or [B]."""

    start_x: torch.Tensor   # world x of the first riser
    width: torch.Tensor     # tread depth (m)
    height: torch.Tensor    # riser height (m), > 0 going up
    count: torch.Tensor     # number of steps (int)


def _tread_index(x: torch.Tensor, stair: StairParams) -> torch.Tensor:
    """[B, 4] which tread (0 = the ground before the stairs) each x is on."""
    start = _per_scenario(stair.start_x, x)
    width = _per_scenario(stair.width, x)
    k = torch.floor((x - start) / torch.clamp(width, min=1e-6)) + 1.0
    count = _per_scenario(stair.count, x).to(x.dtype)
    return torch.clamp(k, torch.zeros_like(count), count)


def stair_foothold_adjust(current_x: torch.Tensor, stair: StairParams,
                          default_delta: float = 0.1):
    """Stair-climbing foothold coordination over the legs: an approaching
    foot holds short of the next riser; a foot in the climb window climbs
    (x past the riser, z one step up) only when its same-end partner is
    not behind it and the body would not straddle more than one step.
    current_x [B, 4]. Returns (next_x [B, 4], dz [B, 4])."""
    dtype = current_x.dtype
    k = _tread_index(current_x, stair)
    nominal = current_x + default_delta
    riser = _per_scenario(stair.start_x, current_x) \
        + k * _per_scenario(stair.width, current_x)
    on_top = k >= _per_scenario(stair.count, current_x).to(dtype)

    rel = nominal - riser
    k_pair = k[:, list(PAIR)]
    max_back = torch.maximum(k[:, 2], k[:, 3])[:, None]
    min_front = torch.minimum(k[:, 0], k[:, 1])[:, None]
    is_front = torch.as_tensor([True, True, False, False],
                               device=current_x.device)
    may_climb = (k <= k_pair) & torch.where(is_front, k <= max_back + 1.0,
                                            k < min_front)

    x_adj = nominal
    x_adj = torch.where((rel > -0.10) & (rel < -0.05), riser - 0.08, x_adj)
    x_adj = torch.where((rel >= -0.05) & (rel < 0.02), riser - 0.05, x_adj)
    in_climb = (rel >= 0.02) & (rel < 0.07) & ~on_top
    x_adj = torch.where(in_climb & may_climb, riser + 0.05, x_adj)
    x_adj = torch.where(in_climb & ~may_climb, riser - 0.04, x_adj)
    height = _per_scenario(torch.as_tensor(stair.height, dtype=dtype,
                                           device=current_x.device),
                           current_x)
    dz = torch.where(in_climb & may_climb, height,
                     torch.zeros_like(x_adj))
    return x_adj, dz


def gap_foothold_adjust(nominal_x: torch.Tensor, gap_centers, gap_width,
                        margin: float = 0.03,
                        current_x: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """[B, 4] per-leg gap clearance for the foothold hook: a foothold that
    lands inside a gap strip snaps to the near edge (+/- (width/2 +
    margin)) while the body approaches, to the far edge once the nominal
    passes the centre or, with `current_x` [B, 4], once the same-end
    partner has already crossed. Disjoint strips only."""
    centers = _centers(gap_centers, nominal_x)
    d = nominal_x[..., None] - centers                      # [B, 4, G]
    half = _half_width(gap_width, nominal_x, margin)
    inside = torch.abs(d) < half
    far = centers + half
    cross = d >= 0.0
    if current_x is not None:
        partner_x = current_x[:, list(PAIR)]
        cross = cross | (partner_x[..., None] > far)
    snapped = torch.where(cross, far, centers - half).expand_as(d)
    any_in = torch.any(inside, dim=-1)
    idx = torch.argmax(inside.to(torch.uint8), dim=-1)
    x_snap = torch.gather(snapped, -1, idx[..., None])[..., 0]
    return torch.where(any_in, x_snap, nominal_x)
