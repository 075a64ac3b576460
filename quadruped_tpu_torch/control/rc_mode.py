"""Joystick / RC mode machine: gamepad buttons -> control mode -> commands
(port of quadruped_tpu/control/rc_mode.py).

A toggles joy control, X starts locomotion or cycles the gait, B stops to
the MPC stand (or re-arms after body-down), Rb toggles BODY_UP /
BODY_DOWN while stopped, Y exits to passive when down. The mode cycle
while moving is STAND -> ADVANCED_TROT -> TROT -> ADVANCED_TROT -> ...;
stand modes zero the twist, trot modes pass the sticks through; walking
backward lowers the body to 0.85 of its height. Each mode maps to an FSM
request, and a trot-mode request while moving raises the gait-switch
pulse. Branch-free on [B] integer states: each scenario can be in the
middle of its own button press.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.fsm import FsmState
from quadruped_tpu_torch.utils import card


class RcMode:
    HARD_CODE = 0
    JOY_TROT = 1
    JOY_ADVANCED_TROT = 2
    JOY_WALK = 3
    JOY_STAND = 4
    BODY_UP = 5
    BODY_DOWN = 6
    EXIT = 7


BUTTONS = ("btn_joy", "btn_gait", "btn_stop", "btn_exit", "btn_updown")


@dataclasses.dataclass
class JoyInput:
    """One gamepad sample per scenario, [B] each (level-triggered buttons;
    rc_update detects the edges)."""

    vx: torch.Tensor          # right stick vertical, m/s
    vy: torch.Tensor          # right stick horizontal, m/s
    wz: torch.Tensor          # left stick horizontal, rad/s
    btn_joy: torch.Tensor     # A: toggle joy control
    btn_gait: torch.Tensor    # X: start locomotion / cycle gait
    btn_stop: torch.Tensor    # B: stop -> MPC stand
    btn_exit: torch.Tensor    # Y: exit -> passive (only when down)
    btn_updown: torch.Tensor  # Rb: body up/down toggle (when stopped)

    @classmethod
    def neutral(cls, vx=0.0, vy=0.0, wz=0.0, batch: int | None = None,
                device=None, **buttons):
        """Each argument a number or a [B] array, broadcast to [B]; on the
        card unless `device` says otherwise."""
        device = card.resolve(device)
        vals = {"vx": vx, "vy": vy, "wz": wz}
        vals.update({name: buttons.get(name, 0.0) for name in BUTTONS})
        vals = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                for k, v in vals.items()}
        if batch is None:
            batch = max(v.numel() if v.ndim else 1 for v in vals.values())
        return cls(**{k: v.expand(batch).clone() for k, v in vals.items()})


@dataclasses.dataclass
class RcState:
    mode: torch.Tensor          # [B] int32 RcMode
    # The last locomotion mode: written, never read, as in the reference.
    prev_mode: torch.Tensor     # [B] int32
    movement: torch.Tensor      # [B] int32 0 stop, 1 move
    body_up: torch.Tensor       # [B] int32 -1 down / 0 neutral / 1 up
    joy_on: torch.Tensor        # [B] 1.0 when joy control is on
    prev_buttons: torch.Tensor  # [B, 5] last tick's levels (edges)


def rc_init(batch: int, start_mode: int = RcMode.JOY_STAND,
            device=None) -> RcState:
    device = card.resolve(device)

    def full(v):
        return torch.full((batch,), v, dtype=torch.int32, device=device)

    return RcState(mode=full(start_mode),
                   prev_mode=full(RcMode.JOY_ADVANCED_TROT),
                   movement=full(0), body_up=full(0),
                   joy_on=torch.ones(batch, device=device),
                   prev_buttons=torch.zeros(batch, 5, device=device))


def _cycle_locomotion_mode(mode: torch.Tensor) -> torch.Tensor:
    """The gait-cycling rules while moving."""
    nxt = torch.where(
        (mode == RcMode.HARD_CODE) | (mode == RcMode.BODY_UP),
        RcMode.JOY_STAND,
        torch.where(mode == RcMode.JOY_STAND, RcMode.JOY_ADVANCED_TROT,
                    torch.where(mode + 1 > RcMode.JOY_ADVANCED_TROT,
                                RcMode.JOY_TROT, mode + 1)))
    return nxt.to(torch.int32)


def rc_update(state: RcState, joy: JoyInput, body_height):
    """One RC tick. Returns (new RcState, TwistCommand, fsm_request [B]
    int32 FsmState, gait_switch pulse [B] float)."""
    levels = torch.stack([getattr(joy, name) for name in BUTTONS], dim=-1)
    edges = (levels > 0.5) & (state.prev_buttons <= 0.5)
    e_joy, e_gait, e_stop, e_exit, e_updown = edges.unbind(-1)

    joy_on = torch.where(e_joy, 1.0 - state.joy_on, state.joy_on)

    # Button logic.
    movement, body_up = state.movement, state.body_up
    request = e_gait                       # X always raises a request
    movement = torch.where(e_gait, 1, movement)

    # B: stop if moving; re-arm body_up if stopped and not down.
    stop_moving = e_stop & (movement == 1)
    movement = torch.where(stop_moving, 0, movement)
    rearm = e_stop & (state.movement == 0) & (state.body_up >= 0)
    body_up = torch.where(rearm, 0, body_up)
    request = request | stop_moving | rearm

    # Y: exit only when stopped and down.
    exiting = e_exit & (movement == 0) & (body_up <= 0)
    request = request | exiting

    # Rb: body up/down toggle when stopped.
    updown = e_updown & (movement == 0)
    body_up = torch.where(updown, torch.where(state.body_up == 0, 1,
                                              -state.body_up), body_up)
    request = request | updown

    # Mode machine.
    moving_mode = _cycle_locomotion_mode(state.mode)
    prev_mode = torch.where(state.mode <= 3, state.mode, state.prev_mode)
    stopped_mode = torch.where(
        exiting, RcMode.EXIT,
        torch.where(body_up == -1, RcMode.BODY_DOWN,
                    torch.where(body_up == 1, RcMode.BODY_UP,
                                RcMode.JOY_STAND)))
    new_mode = torch.where(request, torch.where(movement > 0, moving_mode,
                                                stopped_mode),
                           state.mode).to(torch.int32)

    # Command.
    in_trot = ((new_mode == RcMode.JOY_TROT)
               | (new_mode == RcMode.JOY_ADVANCED_TROT)
               | (new_mode == RcMode.JOY_WALK))
    pass_sticks = in_trot & (joy_on > 0.5)
    zero = torch.zeros_like(joy.vx)
    vx = torch.where(pass_sticks, joy.vx, zero)
    vy = torch.where(pass_sticks, joy.vy, zero)
    wz = torch.where(pass_sticks, joy.wz, zero)
    height = torch.as_tensor(body_height, dtype=torch.float32,
                             device=vx.device).expand_as(vx)
    height = torch.where(vx < -0.01, height * 0.85, height)

    # A trot-mode request while already moving: the gait-transition pulse.
    gait_pulse = (request & in_trot & (state.movement == 1)).to(torch.float32)
    cmd = TwistCommand(linear=torch.stack([vx, vy, zero], dim=-1),
                       angular_z=wz, body_height=height,
                       gait_switch=gait_pulse)

    # FSM request.
    fsm_request = torch.where(
        in_trot | (new_mode == RcMode.JOY_STAND)
        | (new_mode == RcMode.HARD_CODE),
        FsmState.LOCOMOTION,
        torch.where(new_mode == RcMode.BODY_UP, FsmState.STAND_UP,
                    torch.where(new_mode == RcMode.BODY_DOWN,
                                FsmState.SIT_DOWN,
                                FsmState.PASSIVE))).to(torch.int32)

    new_state = RcState(mode=new_mode, prev_mode=prev_mode.to(torch.int32),
                        movement=movement.to(torch.int32),
                        body_up=body_up.to(torch.int32), joy_on=joy_on,
                        prev_buttons=levels)
    return new_state, cmd, fsm_request, gait_pulse
