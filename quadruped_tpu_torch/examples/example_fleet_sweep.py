"""Batched scenario sweep (port of examples/example_fleet_sweep.py): robots
x gaits x velocity commands in one closed loop, split over the ranks of
the process group when it has more than one.

The A1, Go1, Aliengo and Lite3 trotting at vx 0, 0.2, 0.4 and 0.6 m/s
(`sim.scenario.scenario_grid`, 16 scenarios, the fleet of
`benchmarks/fleet.py` untiled), `MpcConfig(horizon=5, qp_iters=30)`, 500
ticks on the SRB sim: one batched MPC solve, one `fused_admm` launch on
the card, for the fleet each time the cadence falls. One process (one
card) starts no process group; launched as several (one per card, with
QTPU_* or torchrun's variables: `distributed.runtime`), the example starts
the group and each rank runs its rows of the grid (`make_mesh`,
`shard_batch`).

    python -m quadruped_tpu_torch.examples.example_fleet_sweep [steps]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from quadruped_tpu_torch.benchmarks import fleet
from quadruped_tpu_torch.distributed import runtime
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.sim.rollout import rollout_init, rollout_segment
from quadruped_tpu_torch.utils import card

STEPS = 500


def shard(f: fleet.Fleet, device) -> tuple[fleet.Fleet, int]:
    """(this rank's rows of the fleet, index of its first scenario); the
    whole fleet without a process group of several ranks. The grid must
    split evenly over the ranks (ValueError)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return f, 0
    if f.n % world:
        raise ValueError(f"{f.n} scenarios do not split evenly over "
                         f"{world} ranks")
    from quadruped_tpu_torch.distributed import make_mesh, shard_batch

    mesh = make_mesh(world, device=device)
    params, gaits, cmd = shard_batch(mesh, (f.params, f.config.gait, f.cmd))
    rows = f.n // world
    first = dist.get_rank() * rows
    return fleet.Fleet(dataclasses.replace(f.config, gait=gaits), params,
                       cmd, f.robots[first:first + rows], rows), first


def run(steps: int = STEPS, device=None) -> dict:
    """The grid's traces [n, ...]: alive [n], base_height_trace [n, T],
    vel_trace [n, T, 3], with `first`, the grid index of row 0 (0 unless
    the grid is split over ranks), and `devices`, the ranks."""
    device = card.resolve(device)
    if not dist.is_initialized():
        # Launched as several processes: the group, and this rank's card
        # as the current one, before anything is built.
        runtime.initialize_from_env(device)
    f, first = shard(fleet.build(1, device), device)
    carry = rollout_init(f.config, f.params, f.n)
    with common.LoopClock(device) as clock:
        _, res = rollout_segment(f.config, f.params, f.cmd, carry, steps)
    out = {"alive": res.alive.cpu().numpy(),
           "base_height_trace": res.base_height_trace.cpu().numpy(),
           "vel_trace": res.vel_trace.cpu().numpy(), "first": first,
           "devices": dist.get_world_size() if dist.is_initialized() else 1}
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    n = len(fleet.ROBOTS) * len(fleet.GAITS) * len(fleet.VX)
    out = run(args.steps, device)
    print(f"{n} scenarios on {out['devices']} device(s)")
    for i, alive in enumerate(out["alive"]):
        print(f"scenario {out['first'] + i:2d}: alive={alive:.0f} "
              f"final_vx={out['vel_trace'][i, -1, 0]:+.2f} m/s "
              f"height={out['base_height_trace'][i, -1]:.3f} m")
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
