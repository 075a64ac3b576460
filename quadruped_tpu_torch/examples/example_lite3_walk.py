"""Lite3 statically-stable walk (port of examples/example_lite3_walk.py;
the engine's `example_lite3_sim` in JOY_WALK, gait table from
quadruped/config/lite3_sim/openloop_gait_generator.yaml's walk section).

One leg swings at a time through the FULL_STANCE -> UNLOAD_FORCE ->
TRUE_SWING -> LOAD_FORCE sub-state machine while the pose planner shifts
the base over the support triangle; the SRB sim, the walk loop of
`benchmarks/walk.py`, the force-balance QP at 300 iterations. No kernel
of the port runs: the walk's QPs are plain torch, as they are plain jnp
in the JAX package.

    python -m quadruped_tpu_torch.examples.example_lite3_walk [--steps 4000]
        [--vx 0.015] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.walk_locomotion import walk_init
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import WALK
from quadruped_tpu_torch.gait.walk import SubLegState
from quadruped_tpu_torch.robots import lite3_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils import card

DT = bench_walk.DT


def build(vx: float = 0.015, device=None) -> bench_walk.Loop:
    """One Lite3 standing on the SRB sim with the walk controller booted."""
    device = card.resolve(device)
    params = lite3_params(device)
    config = bench_walk.walk_config(WALK(device), qp_iters=300)
    cmd = TwistCommand.constant(vx=vx, body_height=params.body_height,
                                device=device)
    sim = srb_sim.srb_sim_init(params, 1)
    walk = walk_init(config, params, srb_sim.observe(
        params, sim, torch.ones(1, 4, device=device)))
    return bench_walk.Loop(config, params, cmd, sim, walk,
                           np.zeros(1, np.int64))


def run(steps: int = 4000, vx: float = 0.015, device=None) -> dict:
    """One robot's traces: the base position after each tick [T, 3] and
    the legs' sub-states [T, 4], with `loop`, what `build` returns advanced
    by the run."""
    device = card.resolve(device)
    loop = build(vx, device)
    with common.LoopClock(device) as clock:
        loop, tr = bench_walk.run(loop, steps, record=True)
    out = {"position": tr["position"][0].cpu().numpy(),
           "sub_state": tr["sub_state"][0].cpu().numpy(), "loop": loop}
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--vx", type=float, default=0.015)
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.steps, args.vx, device)
    pos = out["position"]
    swings = out["sub_state"] == SubLegState.TRUE_SWING
    print(f"walked {pos[-1, 0]:+.3f} m in {args.steps * DT:.1f} s "
          f"(command {args.vx} m/s)")
    print(f"height band: [{pos[:, 2].min():.3f}, {pos[:, 2].max():.3f}] m")
    print(f"swing ticks per leg: {swings.sum(axis=0)}")
    print(f"max simultaneous swings: {swings.sum(axis=1).max()} "
          "(static stability requires <= 1)")
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
