"""Heterogeneous fleets through every path: VELOCITY, POSITION, the walk,
the WBC, the whole-body loop and the robot runner.

    python -m quadruped_tpu_torch.benchmarks.fleet_paths [--path wbc]
        [--batch 1024] [--ticks 100]

The fleet of benchmarks/fleet.py (the A1, Go1, Aliengo and Lite3 of the
JAX examples/example_fleet_sweep.py; `scenario_grid` over four speeds,
16 scenarios, tiled with `tile_scenarios`: one robot per scenario, a
quarter of the batch each) through each path's own benchmark
configuration, with stacked parameters where that benchmark runs the A1:

* `velocity`, `position`: `sim.rollout.rollout` in VELOCITY / POSITION
  mode (TROT, `ForceBalanceConfig()`), the configuration of chip_smoke.py
  phase 8 (vx ~ U(0.1, 0.4) / U(0.0, 0.1));
* `walk`: benchmarks/walk.py on the whole-body sim (the 3.7 s walk
  table, 40 cold ADMM iterations, the pose SQP on replan ticks; vx =
  0.02 + 0.05 U);
* `wbc`: `rollout` with `use_wbc` (ADVANCED_TROT, `MpcConfig(horizon=10)`,
  `WbcConfig()`; vx = 0.2 + 0.4 U), as chip_smoke.py phase 10;
* `wholebody`: benchmarks/whole_body.py (ADVANCED_TROT,
  `MpcConfig(horizon=10, qp_cold_iters=120)`; vx = 0.2 + 0.4 U);
* `runner`: benchmarks/runner.py from the sitting boot (raw noisy
  sensors, the estimators, the FSM's STAND_UP ramp, then the advanced
  trot at `MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120)`);
* `runner_trot`: the same runner booted standing at each robot's body
  height with the FSM put in LOCOMOTION (as `benchmarks.runner.srb_boot`
  puts it on the SRB sim): the advanced trot on estimates from its first
  tick, an MPC solve every cadence.

The runner's sensor noise (level 1) is drawn per tick for the whole fleet
from a numpy seed (`sensor_noise`).

The speeds are drawn from `default_rng(0)` as each benchmark draws them.
Every robot is commanded its own nominal body height less 1 cm (the A1's
0.27 m of the one-robot benchmarks), and `desired_state_init` starts from
each robot's own body height. Each MPC solve of the fleet is one batched
solve, one K1 launch on the card, with each row's force cap its own
robot's m*g. `alone` builds the same path for the scenarios of one robot
with one-robot parameters, which the fleet must equal scenario for
scenario (tests/test_torch_fleet_*.py on the CPU, chip_smoke.py on the
card). Prints one JSON line: ms per tick, ticks/s, robot-seconds per wall
second, K1 launches and each robot's alive share, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control import wbc as wbc_mod
from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       TwistCommand)
from quadruped_tpu_torch.control.fsm import FsmState
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.control.stance_force_balance import \
    ForceBalanceConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
from quadruped_tpu_torch.robots.params import RobotParams, named_params
from quadruped_tpu_torch.sim import rollout as rollout_mod
from quadruped_tpu_torch.sim.scenario import scenario_grid, tile_scenarios
from quadruped_tpu_torch.solvers import fused_admm
from quadruped_tpu_torch.utils import card, tree

PATHS = ("velocity", "position", "walk", "wbc", "wholebody", "runner",
         "runner_trot")
ROBOTS = bench_fleet.ROBOTS
GRID = len(ROBOTS) * len(bench_fleet.VX)      # 16 scenarios
DT = 0.002
# Commanded height below each robot's nominal body height.
HEIGHT_OFFSET = 0.01
# Forward speeds per path: (low, width) of low + width U from default_rng(0).
SPEEDS = {"velocity": (0.1, 0.3), "position": (0.0, 0.1),
          "walk": (0.02, 0.05), "wbc": (0.2, 0.4), "wholebody": (0.2, 0.4),
          "runner": (0.2, 0.0), "runner_trot": (0.15, 0.15)}
MODES = {"velocity": ControlMode.VELOCITY, "position": ControlMode.POSITION}
NOISE_SEED = 8


class RolloutLoop(NamedTuple):
    """A closed loop on the SRB sim (`sim.rollout`): its fixed parts and
    its carry."""

    config: LocomotionConfig
    params: RobotParams
    cmd: TwistCommand
    carry: rollout_mod.RolloutCarry


class Fleet(NamedTuple):
    path: str
    robots: tuple        # [B] robot name of each scenario
    vx: np.ndarray       # [B] commanded forward speeds
    loop: object         # RolloutLoop or the path benchmark's Loop
    rows: np.ndarray     # [B] the scenarios' rows in the whole fleet
    size: int            # scenarios of the whole fleet


def grid_params(batch: int, device=None,
                robots=ROBOTS) -> tuple[RobotParams, tuple]:
    """(stacked parameters, robot names) of the grid of `robots` x the four
    speeds (16 scenarios for the fleet) tiled to `batch`, a multiple of
    the grid."""
    params, _, _, n = scenario_grid(robots, bench_fleet.GAITS,
                                    bench_fleet.VX, device=device)
    if batch % n:
        raise ValueError(f"a batch of the grid is a multiple of {n}, not "
                         f"{batch}")
    per_robot = n // len(robots)
    names = tuple(robots[(i % n) // per_robot] for i in range(batch))
    return tile_scenarios(params, batch // n), names


def speeds(path: str, batch: int) -> np.ndarray:
    """[batch] float32 forward speeds of `path`'s benchmark."""
    low, width = SPEEDS[path]
    return (low + width * np.random.default_rng(0).random(batch)).astype(
        np.float32)


def commanded_height(params: RobotParams) -> torch.Tensor:
    """Each robot's nominal body height less HEIGHT_OFFSET ([] or [B])."""
    return params.body_height - HEIGHT_OFFSET


def locomotion_config(path: str, device=None) -> LocomotionConfig:
    """The controller of the SRB-sim paths (velocity, position, wbc)."""
    if path in MODES:
        return LocomotionConfig(
            mpc=mpc_mod.MpcConfig(),
            swing=swing_mod.SwingConfig(mode=MODES[path]),
            gait=TROT(device), mode=MODES[path],
            force_balance=ForceBalanceConfig())
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT(device),
                            wbc=wbc_mod.WbcConfig(), use_wbc=True)


def build_loop(path: str, params: RobotParams, vx: np.ndarray, device=None,
               seed: int = 0):
    """The closed loop of `path` for robots `params` (one robot, or a fleet
    of len(vx)) booted at t = 0 (the MPC cold start, where the path has
    one, runs here)."""
    device = card.resolve(device)
    batch = len(vx)
    height = commanded_height(params)
    if path in MODES or path == "wbc":
        config = locomotion_config(path, device)
        cmd = TwistCommand.constant(vx=vx, body_height=height, batch=batch,
                                    device=device)
        return RolloutLoop(config, params, cmd,
                           rollout_mod.rollout_init(config, params, batch))
    build = {"walk": bench_walk.build, "wholebody": bench_wb.build}.get(path)
    if build is not None:
        return build(batch, device, vx=vx, params=params, body_height=height)
    return bench_runner.build(batch, device, vx=vx, seed=seed,
                              params=params, body_height=height,
                              stand=path == "runner_trot")


def build(path: str, batch: int, device=None, robots=ROBOTS) -> Fleet:
    """The fleet of `path` at `batch` (a multiple of 16); with `robots`
    another grid (robots=("a1",): the A1 alone, stacked)."""
    params, names = grid_params(batch, device, robots)
    vx = speeds(path, batch)
    return Fleet(path, names, vx, build_loop(path, params, vx, device),
                 np.arange(batch), batch)


def alone(fleet: Fleet, robot: str, device=None) -> Fleet:
    """The scenarios of `robot` in `fleet` as their own loop, with one-robot
    parameters, booted as the fleet was."""
    rows = np.asarray([i for i, r in enumerate(fleet.robots) if r == robot])
    vx = fleet.vx[rows]
    return Fleet(fleet.path, (robot,) * len(rows), vx,
                 build_loop(fleet.path, named_params(robot, device), vx,
                            device), fleet.rows[rows], fleet.size)


def sensor_noise(fleet: Fleet, ticks: int) -> torch.Tensor:
    """[ticks, B, 30] standard normals of the runner's sensor model for the
    next `ticks` ticks: each tick's draw is made for the whole fleet from
    `default_rng((NOISE_SEED, tick))` and cut to the fleet's rows, so that
    a scenario sees the same noise alone as in the fleet."""
    start = fleet.loop.step
    draws = np.stack([np.random.default_rng((NOISE_SEED, start + k))
                      .standard_normal((fleet.size, bench_runner.NOISE_DIM),
                                       dtype=np.float32)[fleet.rows]
                      for k in range(ticks)])
    return torch.as_tensor(draws, device=fleet.loop.prev_v.device)


def run(fleet: Fleet, ticks: int) -> tuple[Fleet, dict]:
    """Advance by `ticks`. Returns (fleet, traces): {"height": [B, T] base
    height after each tick, "q": [B, 12] the final joint angles}."""
    loop = fleet.loop
    if isinstance(loop, RolloutLoop):
        carry, res = rollout_mod.rollout_segment(loop.config, loop.params,
                                                 loop.cmd, loop.carry, ticks)
        return (fleet._replace(loop=loop._replace(carry=carry)),
                {"height": res.base_height_trace, "q": carry.sim.q})
    if fleet.path == "walk":
        loop, tr = bench_walk.run(loop, ticks, record=True)
        height = tr["position"][..., 2]
    elif fleet.path == "wholebody":
        loop, (height, _) = bench_wb.run(loop, ticks)
    else:
        loop, tr = bench_runner.run(loop, ticks, record=True,
                                    noise=sensor_noise(fleet, ticks))
        height = tr["position"][..., 2]
    return fleet._replace(loop=loop), {"height": height,
                                       "q": loop.sim.fb.q}


def state_tensors(fleet: Fleet) -> list:
    """Every tensor of the loop's sim and controller state."""
    loop = fleet.loop
    if isinstance(loop, RolloutLoop):
        parts = (loop.carry.sim, loop.carry.ctrl)
    else:
        ctrl = getattr(loop, {"walk": "walk", "wholebody": "ctrl"}.get(
            fleet.path, "runner"))
        parts = (loop.sim, ctrl)
    return [v for _, v in tree.leaves(parts)
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def alive(fleet: Fleet) -> torch.Tensor:
    """[B] 1.0 for a scenario that stands: not tipped over in the SRB
    rollouts (`sim.rollout`), base above 0.15 m on the whole-body sim (the
    JAX benchmarks' criterion), and for the runner, whose ramp starts
    below that, not dropped to PASSIVE by the FSM's safety check."""
    loop = fleet.loop
    if isinstance(loop, RolloutLoop):
        return 1.0 - loop.carry.dead
    if fleet.path.startswith("runner"):
        return (loop.runner.fsm.state != FsmState.PASSIVE).float()
    return (loop.sim.fb.position[:, 2] > bench_wb.ALIVE_HEIGHT).float()


def base_height(fleet: Fleet) -> torch.Tensor:
    loop = fleet.loop
    if isinstance(loop, RolloutLoop):
        return loop.carry.sim.position[:, 2]
    return loop.sim.fb.position[:, 2]


def mpc_solves(fleet: Fleet, ticks: int) -> int:
    """Batched MPC solves of the next `ticks` ticks from a loop whose every
    scenario stands at MPC iteration 0 (as booted): one every cadence on
    the ADVANCED_TROT paths; none in VELOCITY, POSITION and the walk, and
    none on the runner's STAND_UP ramp (the idle-locomotion shortcut)."""
    config = {"wbc": lambda loop: loop.config,
              "wholebody": lambda loop: loop.config,
              "runner_trot": lambda loop: loop.config.locomotion}.get(
                  fleet.path)
    if config is None:
        return 0
    return -(-ticks // config(fleet.loop).mpc.ticks_per_solve)


def boots_mpc(path: str) -> bool:
    """Whether booting `path` runs the MPC cold start (one K1 launch)."""
    return path in ("wbc", "wholebody", "runner", "runner_trot")


def per_robot(fleet: Fleet, values: torch.Tensor) -> dict:
    """{robot: mean of `values` [B] over its scenarios}."""
    out = {}
    for name in dict.fromkeys(fleet.robots):
        rows = torch.tensor([r == name for r in fleet.robots],
                            device=values.device)
        out[name] = values[rows].float().mean().item()
    return out


def measure(path: str, batch: int, ticks: int, device=None) -> dict:
    """One timed run of `ticks` ticks after the boot and two untimed
    ticks."""
    fleet = build(path, batch, device)
    fleet, _ = run(fleet, 2)
    torch.cuda.synchronize()
    fused_admm.fused_admm.launches = 0
    t0 = time.perf_counter()
    fleet, _ = run(fleet, ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"path": path, "batch": batch, "ticks": ticks,
            "ms_per_tick": 1e3 * wall / ticks,
            "ticks_per_s": batch * ticks / wall,
            "robot_seconds_per_wall_second": batch * ticks * DT / wall,
            "k1_launches": fused_admm.fused_admm.launches,
            "alive": per_robot(fleet, alive(fleet))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=PATHS, default="wbc")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=100)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fleet_paths: no CUDA device; the benchmark "
                         "measures the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure(a.path, a.batch, a.ticks)
    print(json.dumps(dict(
        metric=f"fleet {a.path} closed-loop ticks/s (4 robots, "
               f"batch={a.batch})", value=res["ticks_per_s"],
        unit="ticks/s", **res, card=card.name_and_power_limit())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
