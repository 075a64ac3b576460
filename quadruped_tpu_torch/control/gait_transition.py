"""Online gait switching: decelerate -> stand -> swap gait -> resume (port of quadruped_tpu/control/gait_transition.py).

A rising edge on `TwistCommand.gait_switch` (or `request_transition`)
starts a transition in that scenario: the commanded twist ramps to zero
over DECEL_TIME (ending early once the clock and the feet are all in
stance), the robot holds full stance for STAND_TIME with the gait clock
frozen, then the gait clock restarts on the other gait table. Each
transition toggles between the two tables, so round trips compose.

Every scenario transitions at its own time: the active gait table is a
per-scenario select of the two tables, so `active_gait` returns a table
with [B, 4] and [B] fields, which every consumer of GaitConfig takes.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.gait.scheduler import (GaitConfig, GaitState,
                                                LegState, gait_init)
from quadruped_tpu_torch.utils import card, tree

DECEL_TIME = 1.0
STAND_TIME = 1.0


class TransitionPhase:
    NONE = 0
    DECEL = 1
    STAND = 2


@dataclasses.dataclass
class GaitTransitionState:
    phase: torch.Tensor        # [B] int32 TransitionPhase
    phase_start: torch.Tensor  # [B] time the phase began
    active_idx: torch.Tensor   # [B] 0.0 = gait A, 1.0 = gait B
    prev_switch: torch.Tensor  # [B] last tick's switch-request level


def gait_transition_init(batch: int, device=None) -> GaitTransitionState:
    device = card.resolve(device)
    z = torch.zeros(batch, dtype=torch.float32, device=device)
    return GaitTransitionState(
        phase=torch.full((batch,), TransitionPhase.NONE, dtype=torch.int32,
                         device=device),
        phase_start=z, active_idx=z.clone(), prev_switch=z.clone())


def request_transition(state: GaitTransitionState,
                       t: torch.Tensor) -> GaitTransitionState:
    """Begin a transition where none is active. t: [B]."""
    idle = state.phase == TransitionPhase.NONE
    return dataclasses.replace(
        state, phase=torch.where(idle, TransitionPhase.DECEL,
                                 state.phase).to(torch.int32),
        phase_start=torch.where(idle, t, state.phase_start))


def active_gait(state: GaitTransitionState, gait_a: GaitConfig,
                gait_b: GaitConfig) -> GaitConfig:
    """The active table of each scenario, from two tables shared by the
    batch: [B, 4] leg fields, [B] scalars."""
    pick_b = state.active_idx > 0.5

    def pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(pick_b.reshape((-1,) + (1,) * a.ndim), b, a)

    return GaitConfig(**{f.name: pick(getattr(gait_a, f.name),
                                      getattr(gait_b, f.name))
                         for f in dataclasses.fields(GaitConfig)})


def _full_stance(gs: GaitState) -> GaitState:
    """A gait state pinned to full stance (the MPC-standing hold)."""
    stance4 = torch.full_like(gs.leg_state, LegState.STANCE)
    z4 = torch.zeros_like(gs.normalized_phase)
    return dataclasses.replace(
        gs, leg_state=stance4, cur_leg_state=stance4,
        desired_leg_state=stance4, normalized_phase=z4,
        phase_in_full_cycle=z4, first_swing=z4)


def gait_transition_step(state: GaitTransitionState, gait_state: GaitState,
                         gait_a: GaitConfig, gait_b: GaitConfig,
                         cmd: TwistCommand, t: torch.Tensor,
                         contact: torch.Tensor | None = None):
    """One tick of the transition manager, before `gait_update`.

    Returns (active GaitConfig, adjusted GaitState, scaled cmd, hold [B],
    new transition state). Where hold > 0.5 the caller pins the updated
    gait state to full stance (`hold_stance_gait`)."""
    rising = (cmd.gait_switch > 0.5) & (state.prev_switch <= 0.5)
    idle = state.phase == TransitionPhase.NONE
    start = rising & idle
    state = GaitTransitionState(
        phase=torch.where(start, TransitionPhase.DECEL,
                          state.phase).to(torch.int32),
        phase_start=torch.where(start, t, state.phase_start),
        active_idx=state.active_idx, prev_switch=cmd.gait_switch)

    elapsed = t - state.phase_start
    in_decel = state.phase == TransitionPhase.DECEL
    in_stand = state.phase == TransitionPhase.STAND

    # DECEL -> STAND after the ramp, or as soon as the clock is in its
    # all-stance window and every foot is down.
    can_jump = torch.all(gait_state.desired_leg_state == LegState.STANCE,
                         dim=-1)
    if contact is not None:
        can_jump = can_jump & (torch.amin(contact, dim=-1) > 0.5)
    decel_done = in_decel & ((elapsed >= DECEL_TIME) | can_jump)
    stand_done = in_stand & (elapsed >= STAND_TIME)

    new_phase = torch.where(decel_done, TransitionPhase.STAND, state.phase)
    new_phase = torch.where(stand_done, TransitionPhase.NONE, new_phase)
    new_start = torch.where(decel_done | stand_done, t, state.phase_start)
    new_idx = torch.where(stand_done, 1.0 - state.active_idx,
                          state.active_idx)

    # Command scale from the advanced phase: a ramp to zero in DECEL, zero
    # through the STAND hold.
    scale = torch.where(
        new_phase == TransitionPhase.DECEL,
        torch.clamp(1.0 - elapsed / DECEL_TIME, 0.0, 1.0),
        torch.where(new_phase == TransitionPhase.STAND,
                    torch.zeros_like(elapsed), torch.ones_like(elapsed)))
    cmd_out = dataclasses.replace(cmd, linear=cmd.linear * scale[:, None],
                                  angular_z=cmd.angular_z * scale)

    new_state = dataclasses.replace(state, phase=new_phase.to(torch.int32),
                                    phase_start=new_start,
                                    active_idx=new_idx)
    active = active_gait(new_state, gait_a, gait_b)

    # STAND hold: the gait clock is frozen (reset_time tracks t).
    hold = (in_stand & ~stand_done) | decel_done
    dt = t - gait_state.last_time
    gait_out = dataclasses.replace(
        gait_state, reset_time=torch.where(hold, gait_state.reset_time + dt,
                                           gait_state.reset_time))
    # Swap: the new gait's clock restarts from phase zero.
    fresh = dataclasses.replace(gait_init(active, t.shape[0]),
                                reset_time=t + 0.0 * t,
                                last_time=gait_state.last_time)
    gait_out = tree.where(stand_done, fresh, gait_out)
    return active, gait_out, cmd_out, hold.to(torch.float32), new_state


def hold_stance_gait(hold: torch.Tensor, gs: GaitState) -> GaitState:
    """Apply the stance hold after gait_update where hold [B] is set."""
    return tree.where(hold > 0.5, _full_stance(gs), gs)
