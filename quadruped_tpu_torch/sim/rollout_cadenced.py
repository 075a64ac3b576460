"""Cadence-hoisted batched rollouts: one MPC solve per control period
(port of quadruped_tpu/sim/rollout_cadenced.py).

    for each MPC period:
        one tick with the MPC solving (solve_mode="always")
        ticks_per_solve - 1 ticks holding the forces (solve_mode="never")

The same control semantics as the cadence multiplexing of sim/rollout.py
(the reference holds forces between solves), with exactly one batched
solve, and so one ADMM kernel launch, per period. This is the
scenario-sweep workhorse that benchmarks/bench_rollout.py times in the JAX
package. The parameters may be a fleet (`robots.params.stack_params`), one
robot per scenario of `cmd`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim.rollout import _tip_over, tick_time


class CadencedRolloutResult(NamedTuple):
    sim: srb_sim.SrbSimState
    alive: torch.Tensor              # [B]
    base_height_trace: torch.Tensor  # [B, n_periods]
    vel_trace: torch.Tensor          # [B, n_periods, 3]


def rollout_cadenced(config: LocomotionConfig, params: RobotParams,
                     cmd: TwistCommand, n_periods: int,
                     ticks_per_solve: int | None = None,
                     control_dt: float = 0.002) -> CadencedRolloutResult:
    """Closed-loop rollout of the batch in `cmd`, solving the MPC once per
    `ticks_per_solve` ticks (default: MpcConfig.ticks_per_solve)."""
    if ticks_per_solve is None:
        ticks_per_solve = config.mpc.ticks_per_solve
    solve_config = dataclasses.replace(
        config, mpc=dataclasses.replace(config.mpc, solve_mode="always"))
    hold_config = dataclasses.replace(
        config, mpc=dataclasses.replace(config.mpc, solve_mode="never"))

    b = cmd.linear.shape[0]
    device = cmd.linear.device
    sim = srb_sim.srb_sim_init(params, b)
    obs0 = srb_sim.observe(params, sim, torch.ones_like(sim.q[:, :4]))
    ctrl = locomotion_init(config, params, obs0)

    def tick(sim, ctrl, t, cfg):
        obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
        command, forces, ctrl = locomotion_step(cfg, params, ctrl, obs, cmd,
                                                tick_time(t, b, device))
        stance = stance_contact_mask(ctrl.gait)
        sim = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq,
            1.0 - torch.repeat_interleave(stance, 3, dim=-1), control_dt)
        return sim, ctrl

    dt32 = np.float32(control_dt)
    hs, vs = [], []
    for k in range(n_periods):
        # Times formed in float32 as the JAX scan forms them.
        t0 = np.float32(k) * np.float32(ticks_per_solve) * dt32
        sim, ctrl = tick(sim, ctrl, t0 + dt32, solve_config)
        for i in range(ticks_per_solve - 1):
            sim, ctrl = tick(sim, ctrl, t0 + np.float32(i + 2) * dt32,
                             hold_config)
        hs.append(sim.position[:, 2])
        vs.append(sim.vel_world)
    return CadencedRolloutResult(sim=sim, alive=1.0 - _tip_over(sim),
                                 base_height_trace=torch.stack(hs, 1),
                                 vel_trace=torch.stack(vs, 1))
