"""Desired-state command generation (a frozen copy of the port's twin of quadruped_tpu/control/desired_state.py)."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import card


class ControlMode:
    """Locomotion modes (reference qr_enum_types.h)."""

    VELOCITY = 0
    POSITION = 1
    WALK = 2
    ADVANCED_TROT = 3


@dataclasses.dataclass
class TwistCommand:
    """Raw per-tick command (pre-filter), batch-first."""

    linear: torch.Tensor       # [B, 3] body-frame vx, vy, vz
    angular_z: torch.Tensor    # [B] yaw rate
    body_height: torch.Tensor  # [B] desired CoM height
    gait_switch: torch.Tensor  # [B] gait-switch request channel

    @classmethod
    def constant(cls, vx=0.0, vy=0.0, wz=0.0, body_height=0.27,
                 gait_switch=0.0, batch: int | None = None, device=None):
        """Each argument is a number or a [B] array; all broadcast to [B],
        on the card unless `device` says otherwise."""
        device = card.resolve(device)
        vals = [torch.as_tensor(v, dtype=torch.float32, device=device)
                for v in (vx, vy, wz, body_height, gait_switch)]
        if batch is None:
            batch = max([v.numel() if v.ndim else 1 for v in vals])
        vx, vy, wz, h, gs = (v.expand(batch).clone() for v in vals)
        return cls(linear=torch.stack([vx, vy, torch.zeros_like(vx)], -1),
                   angular_z=wz, body_height=h, gait_switch=gs)


@dataclasses.dataclass
class DesiredStateCommand:
    """Filtered desired state plus filter memory, batch-first."""

    position: torch.Tensor        # [B, 3] world (z = body height)
    rpy: torch.Tensor             # [B, 3]
    velocity: torch.Tensor        # [B, 3] body frame
    omega: torch.Tensor           # [B, 3] body frame (z = yaw rate)
    filtered_linear: torch.Tensor  # [B, 3]
    filtered_wz: torch.Tensor     # [B]


def desired_state_init(batch: int, body_height=0.27,
                       device=None) -> DesiredStateCommand:
    device = card.resolve(device)
    z3 = torch.zeros(batch, 3, dtype=torch.float32, device=device)
    position = z3.clone()
    position[:, 2] = torch.as_tensor(body_height, dtype=torch.float32,
                                     device=device)
    return DesiredStateCommand(
        position=position, rpy=z3, velocity=z3.clone(), omega=z3.clone(),
        filtered_linear=z3.clone(),
        filtered_wz=torch.zeros(batch, dtype=torch.float32, device=device))


def low_pass(prev: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """First-order low-pass: alpha*prev + (1-alpha)*x."""
    return alpha * prev + (1.0 - alpha) * x


FILTER_ALPHA = 0.98
VX_LIMIT = (-1.0, 2.0)
VY_LIMIT = (-0.6, 0.6)
WZ_LIMIT = (-1.2, 1.2)


def desired_state_update(state: DesiredStateCommand,
                         cmd: TwistCommand) -> DesiredStateCommand:
    """One command tick: low-pass + clip the raw twist into `stateDes`."""
    lin = low_pass(state.filtered_linear, cmd.linear, FILTER_ALPHA)
    wz = low_pass(state.filtered_wz, cmd.angular_z, FILTER_ALPHA)
    vx = torch.clamp(lin[:, 0], *VX_LIMIT)
    vy = torch.clamp(lin[:, 1], *VY_LIMIT)
    wz_c = torch.clamp(wz, *WZ_LIMIT)
    zero = torch.zeros_like(vx)
    position = state.position.clone()
    position[:, 2] = cmd.body_height
    return dataclasses.replace(
        state, position=position,
        velocity=torch.stack([vx, vy, zero], -1),
        omega=torch.stack([zero, zero, wz_c], -1),
        filtered_linear=lin, filtered_wz=wz)
