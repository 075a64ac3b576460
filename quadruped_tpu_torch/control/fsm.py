"""Control finite-state machine, batched and branch-free (port of
quadruped_tpu/control/fsm.py).

States PASSIVE / STAND_UP / LOCOMOTION / SIT_DOWN and modes NORMAL /
ESTOP, an integer per scenario. The JAX module's `lax.switch` over the
four state functions is, under `vmap`, a select over all four commands;
here the four commands are formed and selected with `torch.where` on the
[B] states. Transitions are masked updates of (state, entry time, entry
pose).
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control import actions, safety
from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.robots.params import RobotParams


class FsmState:
    PASSIVE = 0
    STAND_UP = 1
    LOCOMOTION = 2
    SIT_DOWN = 3


class FsmMode:
    NORMAL = 0
    TRANSITIONING = 1
    ESTOP = 2


@dataclasses.dataclass
class ControlFsmState:
    state: torch.Tensor             # [B] int32 FsmState
    mode: torch.Tensor              # [B] int32 FsmMode
    state_start_time: torch.Tensor  # [B]
    q_at_entry: torch.Tensor        # [B, 12] pose captured for blends
    desired_state: torch.Tensor     # [B] int32 commanded next state


def fsm_init(q0: torch.Tensor) -> ControlFsmState:
    """Boot in STAND_UP toward LOCOMOTION from the joint angles q0
    [B, 12], on q0's device."""
    b, device = q0.shape[0], q0.device

    def full(v):
        return torch.full((b,), v, dtype=torch.int32, device=device)

    return ControlFsmState(
        state=full(FsmState.STAND_UP), mode=full(FsmMode.NORMAL),
        state_start_time=torch.zeros(b, dtype=torch.float32, device=device),
        q_at_entry=q0.clone(), desired_state=full(FsmState.LOCOMOTION))


def with_request(fsm: ControlFsmState,
                 desired_state: torch.Tensor | None) -> ControlFsmState:
    """The FSM state with the RC request [B] (if any) as its desired state."""
    if desired_state is None:
        return fsm
    return dataclasses.replace(fsm,
                               desired_state=desired_state.to(torch.int32))


def safe_mask(fsm: ControlFsmState, obs: RobotObservation) -> torch.Tensor:
    """[B] 1.0 where the safety post-check passes: the orientation guard
    always, the tip-over height envelope only in LOCOMOTION (stand-up and
    sit-down pass through low heights)."""
    safe = safety.check_safe_orientation(obs)
    in_loco_now = fsm.state == FsmState.LOCOMOTION
    return safe * torch.where(in_loco_now, safety.check_tip_over(obs), 1.0)


def next_state(fsm: ControlFsmState, t: torch.Tensor,
               safe: torch.Tensor) -> torch.Tensor:
    """[B] the state after this tick's transitions: STAND_UP completes after
    its ramp into the desired state, SIT_DOWN into PASSIVE, LOCOMOTION
    leaves on a SIT_DOWN or PASSIVE request, PASSIVE stands up only on an
    explicit STAND_UP request, and an unsafe scenario drops to PASSIVE. No
    transition depends on the locomotion command."""
    state, desired = fsm.state, fsm.desired_state
    elapsed = t - fsm.state_start_time
    standup_done = (state == FsmState.STAND_UP) \
        & (elapsed > actions.STANDUP_DURATION)
    sitdown_done = (state == FsmState.SIT_DOWN) \
        & (elapsed > actions.SITDOWN_DURATION)
    want_switch = (state != desired) & (state == FsmState.LOCOMOTION) \
        & ((desired == FsmState.SIT_DOWN) | (desired == FsmState.PASSIVE))
    want_up = (state == FsmState.PASSIVE) & (desired == FsmState.STAND_UP)
    new = torch.where(standup_done, desired, state)
    new = torch.where(sitdown_done, FsmState.PASSIVE, new)
    new = torch.where(want_switch, desired, new)
    new = torch.where(want_up, FsmState.STAND_UP, new)
    new = torch.where(safe < 0.5, FsmState.PASSIVE, new)
    return new.to(torch.int32)


def fsm_step(params: RobotParams, fsm: ControlFsmState,
             obs: RobotObservation, t: torch.Tensor,
             locomotion_command: HybridCommand | None,
             desired_state: torch.Tensor | None = None):
    """One FSM tick. t: [B] time.

    `locomotion_command` is this tick's locomotion controller output, which
    the FSM passes on in LOCOMOTION; it may be None when no scenario is in
    LOCOMOTION. `desired_state` ([B] int32 FsmState, optional) is the RC
    request channel (control/rc_mode.py).
    Returns (HybridCommand, new FSM state, in_locomotion [B] float).
    """
    fsm = with_request(fsm, desired_state)
    elapsed = t - fsm.state_start_time
    state = fsm.state

    stand_up = actions.standup_command(params, fsm.q_at_entry, elapsed)
    sit_down = actions.sitdown_command(params, fsm.q_at_entry, elapsed)
    passive = safety.damped(stand_up)
    command = safety.pick(state == FsmState.SIT_DOWN, sit_down, passive)
    command = safety.pick(state == FsmState.STAND_UP, stand_up, command)
    if locomotion_command is not None:
        command = safety.pick(state == FsmState.LOCOMOTION,
                              locomotion_command, command)

    # Safety post-check: clip the torques; an unsafe scenario gets pure
    # damping and drops to PASSIVE in ESTOP mode.
    command = safety.clip_command(params, command)
    safe = safe_mask(fsm, obs)
    command = safety.pick(safe > 0.5, command, safety.damped(command))
    estop = safe < 0.5

    new_state = next_state(fsm, t, safe)
    switched = new_state != state
    new_fsm = ControlFsmState(
        state=new_state,
        mode=torch.where(estop, FsmMode.ESTOP,
                         FsmMode.NORMAL).to(torch.int32),
        state_start_time=torch.where(switched, t, fsm.state_start_time),
        q_at_entry=torch.where(switched[:, None], obs.joint_angles,
                               fsm.q_at_entry),
        desired_state=fsm.desired_state)
    in_locomotion = (new_state == FsmState.LOCOMOTION).to(torch.float32)
    return command, new_fsm, in_locomotion
