"""Robot parameters (a frozen copy of the port's twin of quadruped_tpu/robots/params.py).

A `RobotParams` is either one robot model shared by every scenario of a
batch (the factories: A1, Go1, Aliengo, Lite3, Lite2, `named_params`; no
scenario axis, the tensors broadcast against the batch-first state) or a
heterogeneous fleet, one robot per scenario (`stack_params`, `stack`:
every field gains a leading scenario axis, [B], [B, 3, 3], [B, 4, 3],
[B, 12], ...), what `jax.vmap` over the JAX module's stacked pytree gives.
Every path of the port takes either form. Consumers read the two forms
through two rules: `per_scenario` shapes a field to broadcast against a
batch-first tensor, and `index_own` indexes a per-leg or per-link field
(`hip_offset[leg]`, `links_mass[link]`) on its own axes (`rotate_legs`
turns a per-leg field by each scenario's rotation). Where a path
starts (`srb_sim_init`, `locomotion_init`, `walk_init`,
`whole_body_init`, `runner_init`) `check_batch` refuses a fleet whose
scenario axis is not the batch. The factories give the JAX module's
values; `tests/test_torch_params.py` and `tests/test_torch_scenarios.py`
hold them equal field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import card

# Side sign of the hip (abduction) link y-offset per leg: right legs -1.
SIDE_SIGN = (-1.0, 1.0, -1.0, 1.0)
NUM_LEGS = 4


@dataclasses.dataclass
class RobotParams:
    """Static per-robot parameters (f32 tensors; the shapes below, with a
    leading scenario axis when stacked)."""

    total_mass: torch.Tensor        # [] kg
    total_inertia: torch.Tensor     # [3,3] body-frame rotational inertia
    body_mass: torch.Tensor         # [] trunk-only mass
    body_inertia: torch.Tensor      # [3,3]
    body_size: torch.Tensor         # [3]
    body_height: torch.Tensor       # [] nominal standing CoM height
    hip_offset: torch.Tensor        # [4,3] trunk->abad joint, body frame
    hip_length: torch.Tensor        # []
    upper_length: torch.Tensor      # []
    lower_length: torch.Tensor      # []
    default_hip_position: torch.Tensor  # [4,3]
    com_offset: torch.Tensor        # [3]
    links_mass: torch.Tensor        # [3]
    links_inertia: torch.Tensor     # [3,3,3]
    links_com_pos: torch.Tensor     # [3,3]
    motor_kp: torch.Tensor          # [12]
    motor_kd: torch.Tensor          # [12]
    torque_limit: torch.Tensor      # []
    stand_angles: torch.Tensor      # [12]
    standup_angles: torch.Tensor    # [12]
    sitdown_angles: torch.Tensor    # [12]
    friction_coef: torch.Tensor     # [] ground mu used by the MPC

    @property
    def stacked(self) -> bool:
        """Whether every field carries a leading scenario axis (a fleet)."""
        return self.total_mass.ndim == 1

    @property
    def signed_hip_length(self) -> torch.Tensor:
        """[4] ([B, 4] stacked) abad link y-offset with per-leg side sign."""
        return per_scenario(self, self.hip_length, 2) * torch.as_tensor(
            SIDE_SIGN, dtype=torch.float32, device=self.hip_length.device)

    @property
    def max_force(self) -> torch.Tensor:
        """Per-leg vertical force cap fMax = m*g (reference convention)."""
        return self.total_mass * 9.81


def per_scenario(params: RobotParams, value: torch.Tensor,
                 ndim: int) -> torch.Tensor:
    """`value` (a field of `params`, or a tensor made from fields with the
    same leading axis) shaped to broadcast against a batch-first tensor of
    `ndim` dims whose trailing axes are the field's own: unchanged for one
    robot; for a fleet the scenario axis stays first and singleton axes go
    in after it. [B] against [B, 4] is [B, 1], [B, 3] against [B, 4, 3] is
    [B, 1, 3]: where a bare [B] would meet [B, 4] (B = 4) or [B, 3]
    (B = 3) it would broadcast over legs or axes without an error."""
    if not params.stacked:
        return value
    pad = ndim - value.ndim
    if pad < 0:
        raise ValueError(f"a stacked field of shape {tuple(value.shape)} "
                         f"does not fit a {ndim}-dim batch-first tensor")
    return value.reshape(value.shape[:1] + (1,) * pad + value.shape[1:])


def index_own(params: RobotParams, value: torch.Tensor, idx) -> torch.Tensor:
    """`value[idx]` on the field's own axes: a per-leg or per-link field
    indexed as it stands for one robot (`hip_offset[leg]` [3],
    `links_inertia[2, 1, 1]` []); for a fleet the same entry of every
    robot, the scenario axis kept first ([B, 3], [B]). A bare `[leg]`
    would index the scenario axis of a fleet."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    return value[(slice(None),) + idx] if params.stacked else value[idx]


def rotate_legs(params: RobotParams, r: torch.Tensor,
                legs: torch.Tensor) -> torch.Tensor:
    """[B, 4, 3]: r [B, 3, 3] applied to each leg's vector of a per-leg
    field `legs` of `params` ([4, 3] for one robot, [B, 4, 3] for a
    fleet)."""
    return torch.einsum("bij,blj->bli" if params.stacked else "bij,lj->bli",
                        r, legs)


def check_batch(params: RobotParams, batch: int) -> None:
    """Raise ValueError where stacked `params` hold another number of robots
    than `batch`: the scenario axis of a fleet is the batch."""
    if params.stacked and params.total_mass.shape[0] != batch:
        raise ValueError(f"stacked parameters of {params.total_mass.shape[0]}"
                         f" robots for a batch of {batch} scenarios")


def _params(device, *, total_mass, total_inertia_diag, body_mass,
            body_inertia, body_size, body_height, hip_offset, hip_length,
            upper_length, lower_length, default_hip_position, com_offset,
            links_mass, links_inertia, links_com_pos, stand_angles_leg,
            standup_leg=(0.0, 0.9, -1.8),
            sitdown_leg=(-0.167136, 0.934969, -2.54468),
            kp_leg=(100.0, 100.0, 100.0), kd_leg=(1.0, 2.0, 2.0),
            torque_limit=23.0, friction_coef=0.45) -> RobotParams:
    device = card.resolve(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def tile4(leg):
        return f(np.tile(np.asarray(leg, np.float32), 4))

    return RobotParams(
        total_mass=f(total_mass),
        total_inertia=f(np.diag(total_inertia_diag)),
        body_mass=f(body_mass),
        body_inertia=f(np.reshape(body_inertia, (3, 3))),
        body_size=f(body_size),
        body_height=f(body_height),
        hip_offset=f(hip_offset),
        hip_length=f(hip_length),
        upper_length=f(upper_length),
        lower_length=f(lower_length),
        default_hip_position=f(default_hip_position),
        com_offset=f(com_offset),
        links_mass=f(links_mass),
        links_inertia=f(np.reshape(links_inertia, (3, 3, 3))),
        links_com_pos=f(links_com_pos),
        motor_kp=tile4(kp_leg),
        motor_kd=tile4(kd_leg),
        torque_limit=f(torque_limit),
        stand_angles=tile4(stand_angles_leg),
        standup_angles=tile4(standup_leg),
        sitdown_angles=tile4(sitdown_leg),
        friction_coef=f(friction_coef),
    )


def from_config(robot: dict, device) -> RobotParams:
    """One robot's parameters from a configuration file's `robot` entry:
    the keyword arguments of `_params` (its `name` is not one)."""
    return _params(device, **{k: v for k, v in robot.items()
                              if k != "name"})
