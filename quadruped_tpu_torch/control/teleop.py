"""Teleop and command sources: host-side drivers that produce
TwistCommand ticks (port of quadruped_tpu/control/teleop.py).

A keyboard poller for interactive host sessions, precomputed command
traces (a TwistCommand whose leading axis is time), and the keyboard
emulation of the gamepad that drives control/rc_mode.py.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.utils import card

VX_STEP = 0.1
WZ_STEP = 0.2
KEYMAP = {
    "w": (VX_STEP, 0.0, 0.0), "s": (-VX_STEP, 0.0, 0.0),
    "a": (0.0, VX_STEP, 0.0), "d": (0.0, -VX_STEP, 0.0),
    "q": (0.0, 0.0, WZ_STEP), "e": (0.0, 0.0, -WZ_STEP),
}


def apply_key(cmd: TwistCommand, key: str) -> TwistCommand:
    """Keyboard teleop increments; space stops (zero twist, same height)."""
    device = cmd.linear.device
    if key == " ":
        return TwistCommand.constant(body_height=cmd.body_height,
                                     device=device)
    dvx, dvy, dwz = KEYMAP.get(key, (0.0, 0.0, 0.0))
    lin = cmd.linear + torch.as_tensor([dvx, dvy, 0.0], dtype=torch.float32,
                                       device=device)
    return dataclasses.replace(cmd, linear=lin, angular_z=cmd.angular_z + dwz)


def keyboard_teleop_loop(callback, body_height: float = 0.27, device=None):
    """Blocking host loop: read single keys from stdin and hand each new
    command (batch 1) to `callback`; x or ctrl-c quits. Needs a TTY."""
    import termios
    import tty

    cmd = TwistCommand.constant(body_height=body_height, device=device)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            key = sys.stdin.read(1)
            if key in ("\x03", "x"):
                break
            cmd = apply_key(cmd, key)
            callback(cmd)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def step_trace(steps: int, vx_schedule, body_height: float = 0.27,
               device=None) -> TwistCommand:
    """A command trace: [(tick, vx), ...] -> TwistCommand with a leading
    time axis of `steps` (vx holds from each tick on)."""
    device = card.resolve(device)
    vx = torch.zeros(steps, dtype=torch.float32, device=device)
    for tick, value in vx_schedule:
        vx[tick:] = value
    zeros = torch.zeros_like(vx)
    return TwistCommand(linear=torch.stack([vx, zeros, zeros], dim=-1),
                        angular_z=zeros,
                        body_height=torch.full_like(vx, body_height),
                        gait_switch=zeros.clone())


# Keyboard emulation of the gamepad: j = A (toggle joy), k = X
# (locomotion / cycle gait), l = B (stop), u = Y (exit), i = Rb (body
# up/down); wasdqe move the sticks.
RC_BUTTON_KEYS = {"j": "btn_joy", "k": "btn_gait", "l": "btn_stop",
                  "u": "btn_exit", "i": "btn_updown"}


def joy_from_key(key: str, sticks, device=None):
    """(JoyInput of batch 1, new sticks) from one keypress; `sticks` is the
    held (vx, vy, wz) (incremented by wasdqe, zeroed by space)."""
    from quadruped_tpu_torch.control.rc_mode import JoyInput

    vx, vy, wz = sticks
    if key == " ":
        vx = vy = wz = 0.0
    else:
        dvx, dvy, dwz = KEYMAP.get(key, (0.0, 0.0, 0.0))
        vx, vy, wz = vx + dvx, vy + dvy, wz + dwz
    buttons = {}
    name = RC_BUTTON_KEYS.get(key)
    if name:
        buttons[name] = 1.0
    return (JoyInput.neutral(vx=vx, vy=vy, wz=wz, device=device, **buttons),
            (vx, vy, wz))
