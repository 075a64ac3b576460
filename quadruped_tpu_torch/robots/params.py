"""Robot parameters (port of quadruped_tpu/robots/params.py).

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

from quadruped_tpu_torch.utils import card, tree

# Side sign of the hip (abduction) link y-offset per leg: right legs -1.
SIDE_SIGN = (-1.0, 1.0, -1.0, 1.0)
NUM_LEGS = 4
NUM_JOINTS = 12


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


def _replace(params: RobotParams, **fields) -> RobotParams:
    """`params` with the named fields set to float32 tensors of the given
    values on its device."""
    device = params.total_mass.device
    return dataclasses.replace(params, **{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in fields.items()})


# Each factory builds on the card unless `device` says otherwise.
def a1_params(device=None) -> RobotParams:
    """Unitree A1 (reference: quadruped/config/a1_sim/a1_sim.yaml)."""
    return _params(
        device,
        total_mass=13.0,
        total_inertia_diag=[0.24, 0.80, 1.0],
        body_mass=6.0,
        body_inertia=[0.015853, 0, 0, 0, 0.037799, 0, 0, 0, 0.045654],
        body_size=[0.267, 0.194, 0.114],
        body_height=0.28,
        hip_offset=[[0.1805, -0.047, 0.0], [0.1805, 0.047, 0.0],
                    [-0.1805, -0.047, 0.0], [-0.1805, 0.047, 0.0]],
        hip_length=0.08505,
        upper_length=0.2,
        lower_length=0.2,
        default_hip_position=[[0.185, -0.135, 0], [0.185, 0.135, 0],
                              [-0.185, -0.135, 0], [-0.185, 0.135, 0]],
        com_offset=[0.005, 0.00145, 0.000515],
        links_mass=[0.696, 1.013, 0.166],
        links_inertia=[
            0.000469246, -9.409e-06, -3.42e-07,
            -9.409e-06, 0.00080749, -4.66e-07,
            -3.42e-07, -4.66e-07, 0.000552929,
            0.005529065, 4.825e-06, 0.000343869,
            4.825e-06, 0.005139339, 2.2448e-05,
            0.000343869, 2.2448e-05, 0.001367788,
            0.002997972, 0.0, -0.000141163,
            0.0, 0.003014022, 0.0,
            -0.000141163, 0.0, 3.2426e-05],
        links_com_pos=[[-0.0033, 0, 0],
                       [-0.003237, -0.022327, -0.027326],
                       [0.006435, 0, -0.107]],
        stand_angles_leg=(0.0, 0.67, -1.25),
    )


def go1_params(device=None) -> RobotParams:
    """Unitree Go1 (reference: quadruped/config/go1/robot_go1.yaml): the A1
    with Go1's geometry."""
    return _replace(
        a1_params(device),
        body_height=0.295,
        upper_length=0.213,
        lower_length=0.213,
        hip_offset=[[0.17, -0.055, 0.0], [0.17, 0.055, 0.0],
                    [-0.21, -0.055, 0.0], [-0.21, 0.055, 0.0]],
        default_hip_position=[[0.19, -0.14, 0], [0.19, 0.14, 0],
                              [-0.19, -0.14, 0], [-0.19, 0.14, 0]],
        com_offset=[-0.038, -0.005, 0.0005],
        body_inertia=np.diag([0.24, 0.80, 1.0]),
    )


def aliengo_params(device=None) -> RobotParams:
    """Unitree Aliengo (reference: quadruped/config/aliengo_sim/aliengo_sim.yaml)."""
    return _params(
        device,
        total_mass=20.0,
        total_inertia_diag=[0.24, 0.80, 1.0],
        body_mass=9.041,
        body_inertia=[0.033260, -0.0004516, 0.0004876,
                      -0.0004516, 0.161172, 0.0000484,
                      0.0004876, 0.0000484, 0.174604],
        body_size=[0.647, 0.21, 0.13],
        body_height=0.37,
        hip_offset=[[0.2399, -0.051, 0.0], [0.2399, 0.051, 0.0],
                    [-0.2399, -0.051, 0.0], [-0.2399, 0.051, 0.0]],
        hip_length=0.083,
        upper_length=0.25,
        lower_length=0.25,
        default_hip_position=[[0.24, -0.135, 0], [0.24, 0.135, 0],
                              [-0.25, -0.135, 0], [-0.25, 0.135, 0]],
        com_offset=[-0.002, 0.004, 0.000515],
        links_mass=[1.993, 1.013, 0.166],
        links_inertia=[
            0.002904, 7.185e-05, -1.262e-06,
            7.185e-05, 0.004908, 1.75e-06,
            -1.262e-06, 1.75e-06, 0.005587,
            0.005667, 3.597e-06, 0.000491,
            3.597e-06, 0.005847, 1.0086e-05,
            0.000491, 1.0086e-05, 0.000370,
            0.006341, 0, -8.7951e-05,
            0, 0.006355, -1.336e-06,
            -8.7951e-05, -1.336e-06, 3.9188e-05],
        links_com_pos=[[-0.0222, -0.0151, 0],
                       [-0.005607, -0.003877, -0.048199],
                       [0.002781, 0, -0.1425]],
        stand_angles_leg=(0.0, 0.67, -1.25),
        torque_limit=35.0,
    )


def lite3_params(device=None) -> RobotParams:
    """DeepRobotics Lite3 (reference: quadruped/config/lite3/lite3_robot.yaml)."""
    return _params(
        device,
        total_mass=12.72,
        total_inertia_diag=[0.24, 1.0, 1.0],
        body_mass=7.5,
        body_inertia=[0.24, 0, 0, 0, 1.0, 0, 0, 0, 1.0],
        body_size=[0.349, 0.124, 0.15],
        body_height=0.29,
        hip_offset=[[0.1745, -0.062, 0.0], [0.1745, 0.062, 0.0],
                    [-0.1745, -0.062, 0.0], [-0.1745, 0.062, 0.0]],
        hip_length=0.0985,
        upper_length=0.20,
        lower_length=0.21,
        default_hip_position=[[0.1745, -0.16, 0], [0.1745, 0.16, 0],
                              [-0.1745, -0.16, 0], [-0.1745, 0.16, 0]],
        com_offset=[0.005, 0.00145, 0.000515],
        links_mass=[0.428, 0.61, 0.145],
        links_inertia=[
            0.00014538, 8.1579e-07, -1.264e-05,
            8.1579e-07, 0.00024024, 1.3443e-06,
            -1.264e-05, 1.3443e-06, 0.00013038,
            0.001, -2.5e-06, -0.000112,
            -2.5e-06, 0.00116, 3.75e-07,
            -0.000112, 3.75e-07, 0.000268,
            0.000668, -1.2e-08, 6.91e-06,
            -1.2e-08, 6.86e-04, 5.65e-09,
            6.91e-06, 5.65e-09, 3.155e-05],
        links_com_pos=[[-0.0047, -0.0091, -0.0018],
                       [-0.00523, -0.0216, -0.0273],
                       [0.00585, 0, -0.12]],
        stand_angles_leg=(0.0, 0.67, -1.25),
    )


def lite2_params(device=None) -> RobotParams:
    """DeepRobotics Lite2: the Lite3 layout with a lighter trunk."""
    return _replace(lite3_params(device), total_mass=12.0, body_mass=7.0,
                    body_height=0.28)


_FACTORIES = {"a1": a1_params, "go1": go1_params,
              "aliengo": aliengo_params, "lite3": lite3_params,
              "lite2": lite2_params}


def named_params(name: str, device=None) -> RobotParams:
    return _FACTORIES[name](device)


def stack(robots) -> RobotParams:
    """One robot per scenario: the fields of a list of one-robot
    `RobotParams` (the factories', `robots.urdf`'s) stacked along a new
    leading axis."""
    robots = list(robots)
    if any(r.stacked for r in robots):
        raise ValueError("stack takes one-robot parameters")
    return tree.stack(robots)


def stack_params(names, device=None) -> RobotParams:
    """Several named robots along a leading scenario axis (a heterogeneous
    fleet); on the card unless `device` says otherwise."""
    return stack([named_params(n, device) for n in names])
