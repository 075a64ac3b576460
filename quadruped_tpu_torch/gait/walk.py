"""Statically-stable walk gait: the swing window's sub-state machine, batched (port of quadruped_tpu/gait/walk.py).

Each leg's swing window is split into the queue FULL_STANCE ->
UNLOAD_FORCE -> TRUE_SWING -> LOAD_FORCE by the ratio table SUB_RATIOS;
the sub-state is recovered from the phase by comparing it against the
cumulative table, so the phase is the only state. Per scenario: [B, 4]
leg tensors and [B] scalars; the gait table is shared ([4] fields) or per
scenario ([B, 4]).

The named walk tables put every sub-state boundary on a tick in real
numbers (WALK(): leg 0 enters its window at tick 1250, phase 0.75), so
which tick a float32 phase crosses it on depends on the last bit. The JAX
package runs the update in a jitted scan with the gait table a
compile-time constant; there XLA rewrites the division by the period
stance / duty into a product with duty * (1 / stance), folded in float32,
and contracts the swing phase's (phase - duty) into a fused multiply-add
of the unrounded product. The update computes the same, so that its
sub-states change on the ticks of JAX's walk tick (a standalone jitted
scan of the JAX gait rounds the product first, and there a tie can fall
one tick later: the same function is not bit-stable across XLA programs).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.gait.scheduler import GaitConfig, LegState, per_leg


class SubLegState:
    """Walk sub-states (reference qr_enum_types.h SubLegState)."""

    FULL_STANCE = 5
    LOAD_FORCE = 6
    UNLOAD_FORCE = 7
    TRUE_SWING = 8


SUB_QUEUE = (SubLegState.FULL_STANCE, SubLegState.UNLOAD_FORCE,
             SubLegState.TRUE_SWING, SubLegState.LOAD_FORCE)
SUB_RATIOS = (0.2, 0.3, 0.3, 0.2)


@dataclasses.dataclass
class WalkGaitState:
    leg_sub_state: torch.Tensor       # [B, 4] int32 (STANCE or a SubLegState)
    detected_leg_state: torch.Tensor  # [B, 4] int32 (STANCE/SWING/EARLY/LOSE)
    normalized_phase: torch.Tensor    # [B, 4] within the active (sub-)state
    phase_in_full_cycle: torch.Tensor  # [B, 4]
    move_base_phase: torch.Tensor     # [B] pose-planner progress 0..1
    true_swing_start: torch.Tensor    # [B] full-cycle phase of swing start
    true_swing_end: torch.Tensor      # [B]


def _cumulative(like: torch.Tensor):
    """(ratios [4], cum [5]) as float32 tensors: a float32 cumsum, as the
    JAX module builds it, so the sub-state boundaries are the same floats."""
    ratios = torch.as_tensor(SUB_RATIOS, dtype=like.dtype, device=like.device)
    return ratios, torch.cat([torch.zeros_like(ratios[:1]),
                              torch.cumsum(ratios, 0)])


def walk_gait_init(config: GaitConfig, batch: int) -> WalkGaitState:
    duty = config.duty_factor[..., 0].expand(batch)
    _, cum = _cumulative(duty)
    i4 = torch.full((batch, 4), LegState.STANCE, dtype=torch.int32,
                    device=duty.device)
    z4 = torch.zeros((batch, 4), dtype=torch.float32, device=duty.device)
    return WalkGaitState(
        leg_sub_state=i4, detected_leg_state=i4.clone(),
        normalized_phase=z4, phase_in_full_cycle=z4.clone(),
        move_base_phase=torch.zeros_like(duty),
        true_swing_start=duty + (1 - duty) * cum[2],
        true_swing_end=duty + (1 - duty) * cum[3])


def walk_gait_update(config: GaitConfig, state: WalkGaitState,
                     t: torch.Tensor, contact: torch.Tensor) -> WalkGaitState:
    """One walk-gait tick. t: [B] time; contact: [B, 4]."""
    period = config.full_cycle_period
    duty = config.duty_factor
    rem = torch.remainder(config.init_phase * period + t[:, None], period)
    inv_period = duty * (1.0 / config.stance_duration)
    phase = rem * inv_period

    in_stance = phase <= duty
    # XLA contracts rem * inv_period - duty into one fused multiply-add: the
    # exact product less duty, rounded once (exact in float64 here).
    swing_num = (rem.double() * inv_period.double() - duty.double()).to(
        phase.dtype)
    phase_swing = torch.clamp(
        swing_num * (1.0 / torch.clamp(1 - duty, min=1e-6)), 0.0, 1.0)

    ratios, cum = _cumulative(phase)
    idx = torch.sum((phase_swing[..., None] >= cum[1:4]).to(torch.int64),
                    dim=-1)                                   # [B, 4] 0..3
    sub_codes = torch.as_tensor(SUB_QUEUE, dtype=torch.int32,
                                device=phase.device)
    sub_state = sub_codes[idx]
    norm_sub = (phase_swing - cum[idx]) / torch.clamp(ratios[idx], min=1e-6)

    leg_state = torch.where(in_stance, LegState.STANCE, sub_state)
    norm_phase = torch.where(in_stance,
                             phase * (1.0 / torch.clamp(duty, min=1e-6)),
                             norm_sub)

    # moveBasePhase: progress of the pre-swing window of the leg that is
    # approaching TRUE_SWING.
    tss = cum[2]
    mbp_per_leg = torch.where(phase_swing < tss,
                              phase_swing * (1.0 / torch.clamp(tss, min=1e-6)),
                              torch.ones_like(phase_swing))
    active = ~in_stance
    move_base_phase = torch.where(
        active.any(-1),
        torch.amin(torch.where(active, mbp_per_leg,
                               torch.ones_like(mbp_per_leg)), dim=-1),
        torch.ones_like(phase[:, 0]))

    detected = torch.where(in_stance, LegState.STANCE, LegState.SWING)
    past_thresh = norm_phase >= per_leg(
        config.contact_detection_phase_threshold)
    early = ((sub_state == SubLegState.TRUE_SWING) & ~in_stance
             & (contact > 0.5) & past_thresh)
    lose = in_stance & (contact <= 0.5) & past_thresh
    detected = torch.where(early, LegState.EARLY_CONTACT, detected)
    detected = torch.where(lose, LegState.LOSE_CONTACT, detected)

    return dataclasses.replace(
        state, leg_sub_state=leg_state.to(torch.int32),
        detected_leg_state=detected.to(torch.int32),
        normalized_phase=norm_phase, phase_in_full_cycle=phase,
        move_base_phase=move_base_phase)


def load_ratios(state: WalkGaitState) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-leg (f_min_ratio, f_max_ratio) [B, 4] for the force-balance QP's
    walk load/unload ramps: UNLOAD_FORCE ramps the maximum force down,
    LOAD_FORCE ramps it back up, TRUE_SWING pins it near 0; an
    EARLY_CONTACT leg carries only a sliver of force."""
    s = state.leg_sub_state
    phi = state.normalized_phase
    f_max = torch.where(s == SubLegState.UNLOAD_FORCE,
                        10.0 * torch.clamp(1.0 - phi, min=0.001),
                        torch.full_like(phi, 10.0))
    f_max = torch.where(s == SubLegState.TRUE_SWING,
                        torch.full_like(phi, 0.001), f_max)
    f_max = torch.where(s == SubLegState.LOAD_FORCE,
                        10.0 * torch.clamp(phi, min=0.001), f_max)
    f_min = torch.where((s == LegState.STANCE)
                        | (s == SubLegState.FULL_STANCE),
                        torch.full_like(phi, 0.01), torch.zeros_like(phi))
    early = state.detected_leg_state == LegState.EARLY_CONTACT
    f_max = torch.where(early,
                        10.0 * torch.clamp(torch.abs(phi - 0.8), max=0.01),
                        f_max)
    f_min = torch.where(early, torch.full_like(phi, 0.001), f_min)
    return f_min, f_max
