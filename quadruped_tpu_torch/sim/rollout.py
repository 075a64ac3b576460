"""Closed-loop batched rollouts: controller + SRB sim (port of quadruped_tpu/sim/rollout.py).

The JAX `lax.scan` over ticks becomes a Python loop over batch-first
tensors. The MPC runs in "cadence" mode inside the tick. Divergence
(tip-over / NaN) is a per-scenario mask; dead scenarios are frozen.
Traces are batch-first: [B, T, ...].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    LocomotionState,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils import tree


class RolloutResult(NamedTuple):
    sim: srb_sim.SrbSimState          # final sim state
    control: LocomotionState          # final control state
    alive: torch.Tensor               # [B] 1.0 if never diverged
    base_height_trace: torch.Tensor   # [B, T]
    vel_trace: torch.Tensor           # [B, T, 3]
    forces_trace: torch.Tensor        # [B, T, 4, 3]


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
    """Fresh carry at t=0, including the cold-start MPC solve."""
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
    hs, vs, fs = [], [], []
    dt32 = np.float32(control_dt)
    for i in range(carry.step, carry.step + steps):
        t = tick_time(np.float32(i + 1) * dt32, b, device)
        obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
        command, forces, ctrl = locomotion_step(config, params, ctrl, obs,
                                                cmd, t)
        stance = stance_contact_mask(ctrl.gait)
        sim_new = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq,
            1.0 - torch.repeat_interleave(stance, 3, dim=-1), control_dt)
        dead = torch.maximum(dead, _tip_over(sim_new))
        sim = tree.where(dead > 0.5, sim, sim_new)
        hs.append(sim.position[:, 2])
        vs.append(sim.vel_world)
        fs.append(forces)
    new_carry = RolloutCarry(sim=sim, ctrl=ctrl, dead=dead,
                             step=carry.step + steps)
    result = RolloutResult(sim=sim, control=ctrl, alive=1.0 - dead,
                           base_height_trace=torch.stack(hs, 1),
                           vel_trace=torch.stack(vs, 1),
                           forces_trace=torch.stack(fs, 1))
    return new_carry, result


def rollout(config: LocomotionConfig, params: RobotParams,
            cmd: TwistCommand, steps: int, control_dt: float = 0.002):
    """One closed-loop rollout of the batch in `cmd`."""
    carry = rollout_init(config, params, cmd.linear.shape[0])
    _, result = rollout_segment(config, params, cmd, carry, steps,
                                control_dt)
    return result
