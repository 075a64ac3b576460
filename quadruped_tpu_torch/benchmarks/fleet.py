"""Heterogeneous fleet sweep: robots x gaits x commands in one closed loop.

    python -m quadruped_tpu_torch.benchmarks.fleet [--repeats 128]
        [--steps 500]

The twin of the JAX package's examples/example_fleet_sweep.py: the A1,
Go1, Aliengo and Lite3 trotting at vx 0, 0.2, 0.4 and 0.6 m/s
(`scenario_grid`, 16 scenarios), tiled `--repeats` times (128: B = 2048,
`tile_scenarios`), `MpcConfig(horizon=5, qp_iters=30)`, through
`sim.rollout.rollout` on the SRB sim for 500 ticks: one batched MPC solve,
one K1 launch on the card, for the whole fleet each time the cadence
falls. Prints per-robot alive share, final vx and height, then one JSON
line: ms per tick, ticks/s, robot-seconds per wall second and K1
launches, with the card's name and power limit. The example's device
mesh (`make_mesh` / `shard_batch`) is left out: one card.

Beside it, the fixture of the JAX tests/test_scenarios.py (`GRIDS`):
tests/data/fleet_a1.npz keeps `jax.vmap(rollout)` of both grids over 150
ticks and JAX's own spread over the window (one-float32-step nudges of the
start), and `fixture_errors` holds a port run (`fixture_run`) to it:
tests/test_torch_scenarios.py::test_fleet_fixture, on the CPU and on the
card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim.rollout import RolloutResult, rollout
from quadruped_tpu_torch.sim.scenario import scenario_grid, tile_scenarios
from quadruped_tpu_torch.solvers import fused_admm
from quadruped_tpu_torch.utils import card

FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "data" \
    / "fleet_a1.npz"

ROBOTS = ("a1", "go1", "aliengo", "lite3")
GAITS = ("trot",)
VX = (0.0, 0.2, 0.4, 0.6)
REPEATS = 128
STEPS = 500
DT = 0.002
# The JAX tests/test_scenarios.py grids (robots, gaits, vx), 150 ticks.
GRIDS = {"heterogeneous_fleet": (("a1", "go1", "lite3"), ("trot",),
                                 (0.0, 0.3)),
         "multi_gait": (("a1",), ("trot", "bound", "pace"), (0.2,))}
FIXTURE_TICKS = 150
FIXTURE_KEYS = ("base_height_trace", "vel_trace", "forces_trace", "q")
# Port vs JAX: tests/test_torch_rollout.py's limits over the first HEAD
# ticks; over the window 10x JAX's spread with these floors (m, m/s, N,
# rad).
HEAD = 24
HEAD_TOL = {"base_height_trace": 2e-4, "vel_trace": 5e-3,
            "forces_trace": 0.01 * 13.0 * 9.81}
FLOOR = {"base_height_trace": 1e-5, "vel_trace": 1e-4,
         "forces_trace": 0.01 * 13.0 * 9.81, "q": 1e-4}


def config(gait_configs) -> LocomotionConfig:
    """The example's controller: H=5, 30 warm Fast-ADMM iterations."""
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                            swing=swing_mod.SwingConfig(), gait=gait_configs)


class Fleet(NamedTuple):
    config: LocomotionConfig
    params: RobotParams       # stacked, [B, ...]
    cmd: TwistCommand         # [B]
    robots: tuple             # [B] robot name of each scenario
    n: int                    # scenarios of the grid before tiling


def build(repeats: int = REPEATS, device=None, robots=ROBOTS) -> Fleet:
    """The grid of `robots` x GAITS x VX tiled `repeats` times, on the card
    unless `device` says otherwise."""
    params, gait_configs, cmd, n = scenario_grid(robots, GAITS, VX,
                                                 device=device)
    params, gait_configs, cmd = tile_scenarios((params, gait_configs, cmd),
                                               repeats)
    per_robot = n // len(robots)
    names = tuple(robots[(i % n) // per_robot] for i in range(n * repeats))
    return Fleet(config(gait_configs), params, cmd, names, n)


def run(fleet: Fleet, steps: int = STEPS) -> RolloutResult:
    return rollout(fleet.config, fleet.params, fleet.cmd, steps)


def mpc_solves(config: LocomotionConfig, steps: int) -> int:
    """Batched MPC solves of a `rollout` of `steps` ticks: the boot solve,
    then every tick whose MPC iteration falls on the cadence (every
    scenario starts at iteration 0)."""
    k = config.mpc.ticks_per_solve
    return 1 + -(-steps // k)


def per_robot(fleet: Fleet, res: RolloutResult) -> dict:
    """{robot: alive share, final vx and height (means over its
    scenarios), the commanded height and its own nominal body height}."""
    out = {}
    for name in dict.fromkeys(fleet.robots):
        rows = torch.tensor([r == name for r in fleet.robots],
                            device=res.alive.device)
        out[name] = {
            "alive": res.alive[rows].mean().item(),
            "final_vx": res.vel_trace[rows, -1, 0].mean().item(),
            "final_height": res.base_height_trace[rows, -1].mean().item(),
            "final_height_min": res.base_height_trace[rows, -1].min().item(),
            "final_height_max": res.base_height_trace[rows, -1].max().item(),
            "commanded_height": fleet.cmd.body_height[rows][0].item(),
            "body_height": fleet.params.body_height[rows][0].item()}
    return out


def copy_spread(fleet: Fleet, res: RolloutResult) -> float:
    """The largest difference (m) between the tiled copies of any one
    scenario: base heights over the whole run and final positions."""
    n = fleet.n
    h = res.base_height_trace.reshape(-1, n, res.base_height_trace.shape[1])
    p = res.sim.position.reshape(-1, n, 3)
    return max((h - h[:1]).abs().max().item(),
               (p - p[:1]).abs().max().item())


def measure(repeats: int = REPEATS, steps: int = STEPS, device=None) -> dict:
    """One timed `rollout` (its boot solve included) after an untimed
    two-tick one."""
    fleet = build(repeats, device)
    run(fleet, 2)
    torch.cuda.synchronize()
    fused_admm.fused_admm.launches = 0
    t0 = time.perf_counter()
    res = run(fleet, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch = len(fleet.robots)
    return {"batch": batch, "steps": steps, "wall_s": wall,
            "ms_per_tick": 1e3 * wall / steps,
            "ticks_per_s": batch * steps / wall,
            "robot_seconds_per_wall_second": batch * steps * DT / wall,
            "k1_launches": fused_admm.fused_admm.launches,
            "mpc_solves": mpc_solves(fleet.config, steps),
            "copy_spread_m": copy_spread(fleet, res),
            "per_robot": per_robot(fleet, res)}


def fixture_run(case: str, device=None) -> dict:
    """The port's run of a fixture grid: {key of FIXTURE_KEYS and "alive":
    array}, the traces [B, 150, ...], q the final joint angles."""
    params, gait_configs, cmd, _ = scenario_grid(*GRIDS[case],
                                                 device=device)
    res = rollout(config(gait_configs), params, cmd, FIXTURE_TICKS)
    out = {k: getattr(res, k).cpu().numpy() for k in FIXTURE_KEYS[:3]}
    out["q"] = res.sim.q.cpu().numpy()
    out["alive"] = res.alive.cpu().numpy()
    return out


def fixture_errors(got: dict, data, case: str) -> dict:
    """{quantity: (max |got - fixture|, limit)} of a run of `case` against
    the fixture: the first HEAD ticks at HEAD_TOL, the window at 10x
    JAX's spread (floors FLOOR). The alive masks must be equal (raises
    AssertionError)."""
    np.testing.assert_array_equal(got["alive"], data[f"{case}/alive"])
    out = {}
    for k in FIXTURE_KEYS:
        want = data[f"{case}/{k}"]
        if k in HEAD_TOL:
            out[f"{k}@head"] = (float(np.max(np.abs(
                got[k][:, :HEAD] - want[:, :HEAD]))), HEAD_TOL[k])
        out[k] = (float(np.max(np.abs(got[k] - want))),
                  max(10 * float(data[f"{case}/spread/{k}"]), FLOOR[k]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fleet: no CUDA device; the benchmark measures the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure(a.repeats, a.steps)
    for name, r in res.pop("per_robot").items():
        print(f"{name:8s} alive={r['alive']:.3f} "
              f"final_vx={r['final_vx']:+.3f} m/s "
              f"height={r['final_height']:.3f} m (commanded "
              f"{r['commanded_height']:.3f}, body_height "
              f"{r['body_height']:.3f})")
    print(json.dumps(dict(
        metric=f"fleet closed-loop ticks/s (4 robots x 4 commands, "
               f"batch={res['batch']})",
        value=res["ticks_per_s"], unit="ticks/s", **res,
        card=card.name_and_power_limit())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
