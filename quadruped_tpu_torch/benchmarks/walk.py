"""Walk-mode closed loop: statically-stable walk ticks per second on one card.

    python -m quadruped_tpu_torch.benchmarks.walk [--batch 256] [--steps 500]
        [--profile TICKS]

Twin of the JAX package's benchmarks/bench_walk.py: `observe` ->
`walk_step` (walk gait, pose-planner SQP on the ticks that replan, the
force-balance QP with load ramps at 40 cold ADMM iterations, swing spline)
-> `whole_body_step`, on flat ground. Configuration: A1, the 3.7 s walk
table `_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1)`, the
bench's kp/kd, vx = 0.02 + 0.05 U from `default_rng(0)`, body height
0.27 m. The walk runs no kernel of the port: its QPs are plain torch, as
they are plain jnp in the JAX package. One tick is 2 ms of sim time, so
ticks/s / 500 is robot-seconds per wall second. Prints one JSON line
with the card's name and power limit. Unlike the JAX bench it does not
chunk the batch (chunking costs 5-6x in eager torch). With `--profile
TICKS` it also runs TICKS more ticks (no replan among them) under
torch.profiler and prints, as a second JSON line, their wall ms per tick
and the operators with the most host time per tick.

The module also builds the walk loops of the JAX tests (the flat walk on
the SRB sim, the stair climb and the gap crossing on the whole-body sim),
which the CPU tests and chip_smoke.py run from checkpoints of the JAX
package's runs.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control import stance_force_balance as stance_fb
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.walk_locomotion import (WalkConfig,
                                                         WalkState,
                                                         walk_init, walk_step)
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait.scheduler import WALK, _config
from quadruped_tpu_torch.gait.walk import SubLegState
from quadruped_tpu_torch.planner import foot_stepper
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import srb_sim, terrain
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils import card
from quadruped_tpu_torch.utils.convert import to_torch, unflatten

DT = 0.002
STEPS = 500        # 1 s of sim per timed call
ALIVE_HEIGHT = 0.15
# Stance gains of the JAX walk tests and bench.
KP = (100., 200., 100., 100., 100., 200.)
KD = (40., 30., 10., 10., 10., 30.)
# The single 8 cm step of tests/test_stair_climb.py and the 6 cm gap
# strip of tests/test_gap_crossing.py.
RISER_X, STEP_HEIGHT = 0.25, 0.08
GAP_X, GAP_W, GAP_MARGIN = 0.25, 0.06, 0.02
# Checkpoints of the JAX package's walk runs at B=4 (tests/data/walk_a1.npz,
# tests/test_torch_walk_windows.py): run -> (sim, ADMM iterations, forward
# speeds, {checkpoint: event tick}); each window starts LEAD ticks before
# its event and runs WINDOW ticks.
WINDOW, LEAD = 120, 10
WINDOW_RUNS = {
    "flat": ("srb", 300, [0.015, 0.02, 0.01, 0.025],
             {"swing": 625, "replan": 1250}),
    "stair": ("wb", 40, [0.03, 0.025, 0.035, 0.028], {"riser": 925}),
    "gap": ("wb", 40, [0.03, 0.025, 0.035, 0.028], {"edge": 925}),
}


def walk_table(device=None):
    """The 3.7 s walk table of the bench and the stair and gap tests."""
    return _config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1,
                   device=device)


def walk_config(gait, qp_iters: int = 40) -> WalkConfig:
    """The walk controller of the JAX bench and tests: their stance gains,
    `qp_iters` cold ADMM iterations, the SQP pose planner."""
    return WalkConfig(gait=gait, force_balance=stance_fb.ForceBalanceConfig(
        kp=KP, kd=KD, qp_iters=qp_iters))


def stair_terrain():
    """One 8 cm step up at RISER_X (a 5 m tread that starts one tread
    back)."""
    return terrain.stairs(step_length=5.0, step_height=STEP_HEIGHT,
                          start_x=RISER_X - 5.0)


def stair_hook(device=None):
    """The walk's foothold hook for the step: hold short of the riser,
    climb when the leg pair allows."""
    stair = foot_stepper.StairParams(
        *(torch.as_tensor(v, device=card.resolve(device))
          for v in (RISER_X, 5.0, STEP_HEIGHT, 1)))

    def adjust(target, feet):
        x_adj, _ = foot_stepper.stair_foothold_adjust(feet[..., 0], stair,
                                                      default_delta=0.1)
        return torch.cat([x_adj[..., None], target[..., 1:]], dim=-1)

    return adjust


def gap_terrain():
    return terrain.gaps(gap_centers=(GAP_X,), gap_width=GAP_W, depth=0.5)


def gap_hook(device=None):
    """The walk's foothold hook for the gap: snap footholds inside the
    strip to an edge, with pair coordination."""
    centers = torch.as_tensor([GAP_X], device=card.resolve(device))

    def adjust(target, feet):
        x_adj = foot_stepper.gap_foothold_adjust(
            target[..., 0], centers, GAP_W, margin=GAP_MARGIN,
            current_x=feet[..., 0])
        return torch.cat([x_adj[..., None], target[..., 1:]], dim=-1)

    return adjust


def per_scenario(mask: torch.Tensor, fn_a: Callable, fn_b: Callable):
    """A terrain height function or foothold hook that is fn_a in the
    scenarios where mask [B] is True and fn_b in the others."""
    def f(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return torch.where(m, fn_a(x, y), fn_b(x, y))

    return f


class Loop(NamedTuple):
    """A walk closed loop: its fixed parts and its state."""

    config: WalkConfig
    params: RobotParams
    cmd: TwistCommand
    sim: object                  # WholeBodySimState or SrbSimState
    walk: WalkState
    start: np.ndarray            # [B] ticks done per scenario
    model: fb.FloatingBaseModel | None = None   # None: the SRB sim
    contact: wb.ContactModel | None = None
    terrain_height: Callable | None = None
    ground_rpy: torch.Tensor | None = None
    foothold_adjust_fn: Callable | None = None


def build(batch: int, device=None, config: WalkConfig | None = None,
          vx=None, params: RobotParams | None = None,
          body_height=0.27) -> Loop:
    """The bench: B A1 robots (or `params`: one robot, or a fleet of B)
    standing on flat ground on the whole-body sim with the walk controller
    booted; on the card unless `device` says otherwise. vx: [B] forward
    speeds (default 0.02 + 0.05 U); body_height: the commanded height, a
    number or [B]."""
    device = card.resolve(device)
    params = a1_params(device) if params is None else params
    model = fb.build_model(params)
    contact = wb.ContactModel()
    config = walk_config(walk_table(device)) if config is None else config
    if vx is None:
        vx = 0.02 + 0.05 * np.random.default_rng(0).random(batch)
    sim = wb.whole_body_init(params, batch)
    walk = walk_init(config, params, wb.observe(params, model, sim, contact))
    cmd = TwistCommand.constant(vx=np.asarray(vx, np.float32),
                                body_height=body_height, batch=batch,
                                device=device)
    return Loop(config, params, cmd, sim, walk, np.zeros(batch, np.int64),
                model, contact)


def support_mask(walk: WalkState) -> torch.Tensor:
    """[B, 4] 1.0 for the legs not in TRUE_SWING (the SRB sim's stance)."""
    return (walk.gait.leg_sub_state != SubLegState.TRUE_SWING).float()


def run(loop: Loop, steps: int, record: bool = False):
    """Advance the loop by `steps` ticks. Returns (loop, traces): with
    `record`, per tick [B, T, ...] base positions, sub-states, contact
    forces and joint-angle commands, else {}."""
    sim, walk = loop.sim, loop.walk
    device = walk.prev_sub_state.device
    dt32 = np.float32(DT)
    kw = dict(terrain_height=loop.terrain_height, ground_rpy=loop.ground_rpy,
              foothold_adjust_fn=loop.foothold_adjust_fn)
    out = {"position": [], "sub_state": [], "forces": [], "q_cmd": []}
    for i in range(steps):
        t = torch.as_tensor((loop.start + i + 1).astype(np.float32) * dt32,
                            device=device)
        if loop.model is None:
            obs = srb_sim.observe(loop.params, sim, support_mask(walk))
            command, forces, walk = walk_step(loop.config, loop.params, walk,
                                              obs, loop.cmd, t, **kw)
            stance = support_mask(walk)
            sim = srb_sim.srb_sim_step(
                loop.params, sim, forces, stance, command.q, command.dq,
                1.0 - torch.repeat_interleave(stance, 3, dim=-1), DT)
            position = sim.position
        else:
            obs = wb.observe(loop.params, loop.model, sim, loop.contact,
                             terrain_height=loop.terrain_height)
            command, forces, walk = walk_step(loop.config, loop.params, walk,
                                              obs, loop.cmd, t, **kw)
            sim, _ = wb.whole_body_step(loop.params, loop.model, sim,
                                        command, loop.contact, DT,
                                        terrain_height=loop.terrain_height)
            position = sim.fb.position
        if record:
            for key, value in (("position", position),
                               ("sub_state", walk.gait.leg_sub_state),
                               ("forces", forces), ("q_cmd", command.q)):
                out[key].append(value)
    loop = loop._replace(sim=sim, walk=walk, start=loop.start + steps)
    return loop, ({k: torch.stack(v, 1) for k, v in out.items()}
                  if record else {})


def base_position(loop: Loop) -> torch.Tensor:
    return loop.sim.position if loop.model is None else loop.sim.fb.position


def alive(loop: Loop) -> torch.Tensor:
    """[B] 1.0 where the base stands above 0.15 m (the JAX bench's
    criterion)."""
    return (base_position(loop)[:, 2] > ALIVE_HEIGHT).float()


def checkpoints():
    """(key, run, sim, start tick) of each window."""
    for run, (sim, _, _, events) in WINDOW_RUNS.items():
        for name, tick in events.items():
            yield f"{run}_{name}", run, sim, tick - LEAD


def _concat(parts):
    """Nested dicts of [4, ...] arrays -> one of [4 n, ...] arrays."""
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts, axis=0)


def window_loops(data, device=None):
    """The two batches of windows of the fixture `data` (an np.load of
    tests/data/walk_a1.npz), resumed from the JAX states: {"srb": loop,
    "wb": loop} and {checkpoint: rows of its batch}. The whole-body batch
    takes the stair terrain and hook in its stair rows and the gap's in
    the others."""
    device = card.resolve(device)
    params = a1_params(device)
    groups: dict = {"srb": [], "wb": []}
    for key, run, sim_kind, start in checkpoints():
        groups[sim_kind].append((key, run, start))
    loops, rows = {}, {}
    for sim_kind, members in groups.items():
        states = _concat([unflatten(data, f"{key}/state")
                          for key, _, _ in members])
        vx = np.concatenate([WINDOW_RUNS[run][2] for _, run, _ in members])
        for i, (key, _, _) in enumerate(members):
            rows[key] = slice(4 * i, 4 * i + 4)
        qp_iters = WINDOW_RUNS[members[0][1]][1]
        cmd = TwistCommand.constant(vx=vx.astype(np.float32),
                                    body_height=0.27, device=device)
        walk = to_torch(states["walk"], WalkState, device=device)
        starts = np.repeat([start for _, _, start in members], 4)
        if sim_kind == "srb":
            loops[sim_kind] = Loop(
                walk_config(WALK(device), qp_iters), params, cmd,
                to_torch(states["sim"], srb_sim.SrbSimState, device=device),
                walk, starts)
            continue
        is_stair = torch.as_tensor(
            np.repeat([run == "stair" for _, run, _ in members], 4),
            device=device)
        loops[sim_kind] = Loop(
            walk_config(walk_table(device), qp_iters), params, cmd,
            to_torch(states["sim"], wb.WholeBodySimState, device=device),
            walk, starts, fb.build_model(params), wb.ContactModel(),
            terrain_height=per_scenario(is_stair, stair_terrain(),
                                        gap_terrain()),
            foothold_adjust_fn=per_scenario(is_stair, stair_hook(device),
                                            gap_hook(device)))
    return loops, rows


# Port vs the JAX windows: a quantity may differ from JAX's run by FACTOR
# times JAX's own spread (its window restarted from the base height one
# float32 step up, kept in the fixture as `nudged`; the largest over the
# windows on the same simulator) or by FLOOR, whichever is larger. Forces
# are compared on the ticks where no run's polish missed its minimizer, and
# the port may miss on at most MISS_SLACK more ticks than JAX a window.
FACTOR = {"position": 10.0, "q_cmd": 10.0, "forces": 2.0}
FLOOR = {"position": 1e-5, "q_cmd": 1e-3, "forces": 0.01 * 13.0 * 9.81}
MISS_SLACK = 2


def missed(forces: np.ndarray) -> np.ndarray:
    """[..., 4, 3] -> [...]: forces outside a leg's friction pyramid or
    pulling on the ground (a polish miss of the force-balance QP), with
    0.5 N of slack."""
    fz = forces[..., 2]
    ft = np.max(np.abs(forces[..., :2]), axis=-1)
    return np.any((fz < -0.5) | (ft > 0.45 * np.maximum(fz, 0.0) + 0.5),
                  axis=-1)


def _distance(a: dict, b: dict, key: str, held: np.ndarray) -> float:
    d = np.abs(a[key] - b[key])
    if key == "forces":
        d = d.max((-1, -2))[held]
    return float(d.max()) if d.size else 0.0


def window_errors(data, port: dict) -> dict:
    """{checkpoint: {quantity: (port error, limit)}} of the port's window
    traces `port` ({checkpoint: {quantity: [4, T, ...]}}, T <= WINDOW: the
    first T ticks of each window) against the fixture `data`; sub-states
    must be equal and the misses within MISS_SLACK (raises AssertionError
    otherwise). The limits come from JAX's spread over the whole windows."""
    want, nudged, spread = {}, {}, {}
    for key, _, sim_kind, _ in checkpoints():
        want[key] = {k: data[f"{key}/trace/{k}"]
                     for k in list(FACTOR) + ["sub_state"]}
        nudged[key] = {k: data[f"{key}/nudged/{k}"] for k in FACTOR}
        held = ~(missed(want[key]["forces"])
                 | missed(nudged[key]["forces"]))
        for k in FACTOR:
            spread[sim_kind, k] = max(spread.get((sim_kind, k), 0.0),
                                      _distance(nudged[key], want[key], k,
                                                held))
    out = {}
    for key, _, sim_kind, _ in checkpoints():
        got = port[key]
        ticks = got["sub_state"].shape[1]
        ref = {k: v[:, :ticks] for k, v in want[key].items()}
        np.testing.assert_array_equal(got["sub_state"], ref["sub_state"],
                                      err_msg=key)
        miss_port, miss_jax = missed(got["forces"]), missed(ref["forces"])
        assert miss_port.sum() <= miss_jax.sum() + MISS_SLACK, (
            key, int(miss_port.sum()), int(miss_jax.sum()))
        held = ~(miss_port | miss_jax)
        out[key] = {k: (_distance(got, ref, k, held),
                        max(FACTOR[k] * spread[sim_kind, k], FLOOR[k]))
                    for k in FACTOR}
        out[key]["missed"] = (int(miss_port.sum()), int(miss_jax.sum()))
    return out


def measure(batch: int, steps: int = STEPS, device=None) -> dict:
    """Time one run of `steps` ticks from the booted state, after two
    untimed ticks of another loop."""
    run(build(batch, device), 2)
    loop = build(batch, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = run(loop, steps)
    torch.cuda.synchronize()
    rate = batch * steps / (time.perf_counter() - t0)
    return {"ticks_per_s": rate, "robot_seconds_per_wall_second":
            rate * DT, "alive_fraction": alive(out).mean().item()}


def host_profile(loop: Loop, ticks: int, top: int = 15) -> dict:
    """Wall ms per tick of `ticks` ticks under torch.profiler, and the
    operators with the most self host time per tick (ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(loop, ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:top]
    return {"profiled_ms_per_tick": 1e3 * wall / ticks,
            "top_host_ms_per_tick": {
                e.key: [e.self_cpu_time_total / 1e3 / ticks, e.count / ticks]
                for e in rows}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--profile", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk: no CUDA device; the benchmark measures the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure(a.batch, a.steps)
    print(json.dumps({
        "metric": f"walk-mode closed-loop ticks/s (whole-body sim + "
                  f"force-balance QP iters=40 cold + SQP pose planner, "
                  f"batch={a.batch})",
        "value": res["ticks_per_s"], "unit": "ticks/s",
        "alive_fraction": res["alive_fraction"],
        "robot_seconds_per_wall_second":
            res["robot_seconds_per_wall_second"],
        "card": card.name_and_power_limit()}))
    if a.profile:
        loop, _ = run(build(a.batch), 2)
        print(json.dumps(host_profile(loop, a.profile)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

