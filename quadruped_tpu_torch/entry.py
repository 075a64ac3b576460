"""The port's entry points: one batched advanced-trot control tick, and one
sharded closed-loop step on a device mesh.

`entry()` is the twin of the JAX package's `__graft_entry__.entry()`: the
A1 advanced-trot MPC control tick (gait clocks, swing, the convex-MPC QP
whose ADMM loop is the `fused_admm` kernel on the card, the torque map) on
32 scenarios at
`MpcConfig(horizon=10, qp_iters=40, qp_cold_iters=16)`, commands vx evenly
spaced from 0 to 0.6 m/s.

    fn, args = entry()          # on the card
    tau, forces = fn(*args)     # [32, 12], [32, 4, 3]

`dryrun_multichip(n)` is the twin of `__graft_entry__.dryrun_multichip`: a
(dp, sp) mesh of n ranks (`distributed.make_mesh`), a batch of 2n A1
scenarios, this rank's rows booted (the MPC cold start: one K1 launch) and
run through one full closed-loop step (`observe`, `locomotion_step` with
its MPC solve: a second K1 launch, `srb_sim_step`) at the production
`MpcConfig()`, the mean |f| reduced over the mesh.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
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


class DryrunResult(NamedTuple):
    """What a dry run leaves on this rank."""

    forces: torch.Tensor   # [B_local, 4, 3] world-frame MPC forces
    stat: torch.Tensor     # mean |f| over the mesh's whole batch
    rows: slice            # this rank's rows of the global batch


def dryrun_config(device=None) -> LocomotionConfig:
    """The production `MpcConfig()` (H=10, 24 warm Fast-ADMM iterations,
    the 400-iteration boot), or with QTPU_DRYRUN_TINY=1 the JAX smoke
    configuration (H=5, 4 iterations, a 16-iteration boot); the gait
    table on `device` (the card unless it says otherwise)."""
    if os.environ.get("QTPU_DRYRUN_TINY", "0") == "1":
        mpc = mpc_mod.MpcConfig(horizon=5, qp_iters=4, qp_cold_iters=16)
    else:
        mpc = mpc_mod.MpcConfig()
    return LocomotionConfig(mpc=mpc, swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT(card.resolve(device)))


def dryrun_build(config: LocomotionConfig, batch: int, rows: slice, device):
    """(params, sim, ctrl, cmd) of rows `rows` of the dry run's batch of
    `batch` scenarios (vx evenly spaced from 0 to 0.6 m/s, 0.27 m), booted
    on `device`: the boot's cold start is one K1 launch."""
    params = a1_params(device)
    vx = torch.linspace(0.0, 0.6, batch, dtype=torch.float32)[rows]
    n = vx.shape[0]
    sim = srb_sim.srb_sim_init(params, n)
    obs = srb_sim.observe(params, sim, torch.ones_like(sim.q[:, :4]))
    ctrl = locomotion_init(config, params, obs)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27, device=device)
    return params, sim, ctrl, cmd


def dryrun_step(config: LocomotionConfig, params, sim, ctrl, cmd):
    """One full closed-loop step at t = 2 ms: observe, locomotion_step,
    srb_sim_step. Returns (sim, ctrl, forces [B, 4, 3])."""
    b = sim.q.shape[0]
    t = torch.full((b,), 0.002, dtype=torch.float32, device=sim.q.device)
    obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
    hybrid, forces, ctrl = locomotion_step(config, params, ctrl, obs, cmd, t)
    stance = stance_contact_mask(ctrl.gait)
    swing_mask = 1.0 - torch.repeat_interleave(stance, 3, dim=-1)
    sim = srb_sim.srb_sim_step(params, sim, forces, stance, hybrid.q,
                               hybrid.dq, swing_mask, 0.002)
    return sim, ctrl, forces


def dryrun_multichip(n_devices: int, device=None) -> DryrunResult:
    """Build an n_devices-rank (dp, sp) mesh (sp = 2 where n_devices is
    even and above 2, as in JAX), take this rank's rows of a batch of
    2 n_devices scenarios, boot them and run one full closed-loop step;
    the mean |f| reduces over the mesh. Raises when the statistic is not
    finite. On the card unless `device` says otherwise; a world of more
    than one rank needs `distributed.runtime.initialize_from_env` first."""
    from quadruped_tpu_torch.distributed import batch_sharding, make_mesh
    from quadruped_tpu_torch.distributed.mesh import mesh_device
    from quadruped_tpu_torch.distributed.scaling import sharded_solve_stats

    sp = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    mesh = make_mesh(n_devices, sp=sp, device=device)
    batch = 2 * n_devices
    rows = batch_sharding(mesh).rows(batch)
    device = mesh_device(mesh)
    config = dryrun_config(device)
    params, sim, ctrl, cmd = dryrun_build(config, batch, rows, device)

    def step(_):
        return dryrun_step(config, params, sim, ctrl, cmd)[2]

    forces, stat = sharded_solve_stats(mesh, step)(None)
    if not torch.isfinite(stat):
        raise RuntimeError("multichip dry run produced non-finite stats")
    return DryrunResult(forces=forces, stat=stat, rows=rows)
