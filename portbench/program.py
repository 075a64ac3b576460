"""The system under test, built from a configuration file: the port's
robot, gait, controller and simulator objects. This is the only module of
the harness that imports the port."""

from __future__ import annotations

import torch

from quadruped_tpu_torch.control import mpc, swing, wbc
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait.scheduler import named_gait
from quadruped_tpu_torch.robots.params import named_params


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def locomotion(config: dict, device) -> tuple:
    """(LocomotionConfig, RobotParams) of the configuration."""
    cfg = LocomotionConfig(
        mpc=mpc.MpcConfig(**_tuples(config["mpc"])),
        swing=swing.SwingConfig(**_tuples(config["swing"])),
        gait=named_gait(config["gait"]["name"], device),
        wbc=(wbc.WbcConfig(**_tuples(config["wbc"])) if config["wbc"]
             else None),
        use_wbc=config["use_wbc"])
    return cfg, named_params(config["robot"]["name"], device)


def command(cmds: dict) -> TwistCommand:
    """The program's command from the generator's draws."""
    vx = cmds["vx"]
    return TwistCommand(linear=torch.stack([vx, cmds["vy"],
                                            torch.zeros_like(vx)], -1),
                        angular_z=cmds["wz"],
                        body_height=cmds["body_height"],
                        gait_switch=torch.zeros_like(vx))


def rollout():
    """The rollout module (rollout_init, rollout_segment)."""
    from quadruped_tpu_torch.sim import rollout as mod
    return mod


def bench():
    """The MPC-update benchmark module (build_bench)."""
    from quadruped_tpu_torch import bench as mod
    return mod
