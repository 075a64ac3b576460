"""Closed-loop batched rollouts: controller + SRB sim (a frozen copy of the port's twin of quadruped_tpu/sim/rollout.py).

The JAX `lax.scan` over ticks becomes a Python loop over batch-first
tensors. The MPC runs in "cadence" mode inside the tick; with
`config.use_wbc` the rollout builds the whole-body model and the WBC runs
inside the tick as well. Divergence (tip-over / NaN) is a per-scenario
mask; dead scenarios are frozen. Traces are batch-first: [B, T, ...];
beside the JAX module's traces, `tau_trace` keeps the commands'
feed-forward torques, which the SRB sim does not apply (it welds stance
feet and servoes swing joints), so that the WBC's output can be seen. The
parameters are one robot or a fleet, one robot per scenario
(`robots.params.stack_params`, `sim.scenario.scenario_grid`), whose
scenario axis must be the batch (`rollout_init` raises otherwise), in
every mode and with the WBC.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.desired_state import TwistCommand
from portbench.reference.locomotion import (LocomotionConfig,
                                                    LocomotionState,
                                                    locomotion_init,
                                                    locomotion_step)
from portbench.reference import se3
from portbench.reference import floating_base as fb
from portbench.reference.scheduler import stance_contact_mask
from portbench.reference.params import RobotParams
from portbench.reference import srb_sim
from portbench.reference import tree


class RolloutResult(NamedTuple):
    sim: srb_sim.SrbSimState          # final sim state
    control: LocomotionState          # final control state
    alive: torch.Tensor               # [B] 1.0 if never diverged
    base_height_trace: torch.Tensor   # [B, T]
    vel_trace: torch.Tensor           # [B, T, 3]
    forces_trace: torch.Tensor        # [B, T, 4, 3]
    tau_trace: torch.Tensor           # [B, T, 12] feed-forward torques


@dataclasses.dataclass
class RolloutCarry:
    """Resumable closed-loop state plus the global step counter."""

    sim: srb_sim.SrbSimState
    ctrl: LocomotionState
    dead: torch.Tensor                # [B] 1.0 once diverged
    step: int


def _tip_over(state: srb_sim.SrbSimState) -> torch.Tensor:
    """Base z outside [0.08, 0.45], |roll| or |pitch| > 0.6 rad, or NaN."""
    rpy = se3.quat_to_rpy(state.quat)
    z = state.position[:, 2]
    bad = ((z < 0.08) | (z > 0.45) | (torch.abs(rpy[:, 0]) > 0.6)
           | (torch.abs(rpy[:, 1]) > 0.6))
    return (bad | ~torch.isfinite(z)).float()


def tick_time(value: float, batch: int, device) -> torch.Tensor:
    """[B] float32 time; `value` is formed in float32 by the caller, as
    the JAX rollouts form it inside their scans."""
    return torch.full((batch,), float(value), dtype=torch.float32,
                      device=device)


def rollout_init(config: LocomotionConfig, params: RobotParams,
                 batch: int) -> RolloutCarry:
    """Fresh carry at t=0, including the cold-start MPC solve. Raises
    ValueError when stacked `params` hold another number of robots than
    `batch`."""
    sim0 = srb_sim.srb_sim_init(params, batch)
    obs0 = srb_sim.observe(params, sim0, torch.ones_like(sim0.q[:, :4]))
    ctrl0 = locomotion_init(config, params, obs0)
    return RolloutCarry(sim=sim0, ctrl=ctrl0,
                        dead=torch.zeros_like(sim0.t), step=0)


def rollout_segment(config: LocomotionConfig, params: RobotParams,
                    cmd: TwistCommand, carry: RolloutCarry, steps: int,
                    control_dt: float = 0.002):
    """Advance a rollout by `steps` ticks; returns (new carry, result)."""
    sim, ctrl, dead = carry.sim, carry.ctrl, carry.dead
    b, device = sim.t.shape[0], sim.t.device
    hs, vs, fs, taus = [], [], [], []
    dt32 = np.float32(control_dt)
    model = fb.build_model(params) if config.use_wbc else None
    for i in range(carry.step, carry.step + steps):
        t = tick_time(np.float32(i + 1) * dt32, b, device)
        obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
        command, forces, ctrl = locomotion_step(config, params, ctrl, obs,
                                                cmd, t, model=model)
        stance = stance_contact_mask(ctrl.gait)
        sim_new = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq,
            1.0 - torch.repeat_interleave(stance, 3, dim=-1), control_dt)
        dead = torch.maximum(dead, _tip_over(sim_new))
        sim = tree.where(dead > 0.5, sim, sim_new)
        hs.append(sim.position[:, 2])
        vs.append(sim.vel_world)
        fs.append(forces)
        taus.append(command.tau)
    new_carry = RolloutCarry(sim=sim, ctrl=ctrl, dead=dead,
                             step=carry.step + steps)
    result = RolloutResult(sim=sim, control=ctrl, alive=1.0 - dead,
                           base_height_trace=torch.stack(hs, 1),
                           vel_trace=torch.stack(vs, 1),
                           forces_trace=torch.stack(fs, 1),
                           tau_trace=torch.stack(taus, 1))
    return new_carry, result


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build(config: dict, device) -> tuple:
    """(LocomotionConfig, RobotParams) from a configuration file."""
    from portbench.reference import mpc, params as params_mod, scheduler
    from portbench.reference import swing, wbc
    cfg = LocomotionConfig(
        mpc=mpc.MpcConfig(**_tuples(config["mpc"])),
        swing=swing.SwingConfig(**_tuples(config["swing"])),
        gait=scheduler.from_config(config["gait"], device),
        wbc=(wbc.WbcConfig(**_tuples(config["wbc"])) if config["wbc"]
             else None),
        use_wbc=config["use_wbc"])
    return cfg, params_mod.from_config(config["robot"], device)


def command(cmds: dict) -> TwistCommand:
    """The command of the generator's draws."""
    vx = cmds["vx"]
    return TwistCommand(linear=torch.stack([vx, cmds["vy"],
                                            torch.zeros_like(vx)], -1),
                        angular_z=cmds["wz"],
                        body_height=cmds["body_height"],
                        gait_switch=torch.zeros_like(vx))
