"""The port's entry point: one batched advanced-trot control tick.

Twin of the JAX package's `__graft_entry__.entry()`: the A1 advanced-trot
MPC control tick (gait clocks, swing, the convex-MPC QP whose ADMM loop is
the `fused_admm` kernel on the card, the torque map) on 32 scenarios at
`MpcConfig(horizon=10, qp_iters=40, qp_cold_iters=16)`, commands vx evenly
spaced from 0 to 0.6 m/s.

    fn, args = entry()          # on the card
    tau, forces = fn(*args)     # [32, 12], [32, 4, 3]
"""

from __future__ import annotations

import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils import card

BATCH = 32


def entry(device=None):
    """(fn, args): `fn(ctrl, obs, cmd, t)` is one batched control tick and
    returns (tau [B, 12], forces [B, 4, 3]); args hold the booted state.
    On the card unless `device` says otherwise."""
    device = card.resolve(device)
    params = a1_params(device)
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=40, qp_cold_iters=16),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(device))
    sim = srb_sim.srb_sim_init(params, BATCH)
    obs = srb_sim.observe(params, sim, torch.ones_like(sim.q[:, :4]))
    ctrl = locomotion_init(config, params, obs)
    cmd = TwistCommand.constant(
        vx=torch.linspace(0.0, 0.6, BATCH, dtype=torch.float32),
        body_height=0.27, device=device)
    t = torch.full((BATCH,), 0.002, dtype=torch.float32, device=device)

    def fn(ctrl_state, observation, command, time_now):
        hybrid, forces, _ = locomotion_step(config, params, ctrl_state,
                                            observation, command, time_now)
        return hybrid.tau, forces

    return fn, (ctrl, obs, cmd, t)
