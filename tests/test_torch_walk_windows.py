"""The port's walk closed loop, restarted from checkpoints of the JAX
package's runs, against the JAX traces that follow (CPU).

The JAX walks run thousands of ticks (the flat walk 6,500, the stair climb
12,000, the gap crossing 20,000), more than the port's eager CPU tick
(~0.2 s at B=8) affords here. So the JAX package ran each once at B=4 (four
forward speeds) and tests/data/walk_a1.npz keeps its full state (sim +
WalkState) at these checkpoints, with the per-tick traces of the WINDOW
ticks that follow:

* `flat_swing`: the flat walk of tests/test_walk_locomotion.py (SRB sim,
  WALK(), 300 ADMM iterations), LEAD ticks before the first TRUE_SWING
  entry (tick 625);
* `flat_replan`: the same run before leg 0 enters its pre-swing window
  (tick 1250), where the pose planner's SQP replans;
* `stair_riser`: the stair climb of tests/test_stair_climb.py (whole-body
  sim, the 3.7 s table, 40 iterations, the stair hook) before FR's swing
  onto the riser (tick 925);
* `gap_edge`: the gap crossing of tests/test_gap_crossing.py before FR's
  swing across the strip to its far edge (tick 925).

The port starts from each checkpoint through `utils.convert.to_torch` and
runs the window: the two SRB windows as one batch of 8, the stair and gap
windows as another, their terrain and foothold hooks chosen per scenario.
The sub-states must match exactly. The walk amplifies float32 rounding:
the force QP's kappa ~ 1e8 and, on the whole-body sim, the stiff contact.
So the fixture also keeps each window run by JAX again from the base
height one float32 step up (`nudged`), and base positions and joint-angle
commands may differ from JAX's by 10x, forces by 2x, JAX's own spread on
that simulator (benchmarks/walk.py `window_errors`, with floors of 1e-5 m,
1e-3 rad and 1% m*g). Forces are compared on the ticks where no run's
active-set polish met a singular Gram (ROADMAP §C; `missed`), and the port
may miss on at most 2 more ticks a window than JAX. CPU readings, port vs
JAX (JAX's spread): SRB position 6.2e-6 m (2.6e-5), forces 1.51 N (4.85),
q 1.3e-4 rad (4.9e-5); whole-body position 5.0e-4 m (4.5e-4), forces
5.88 N (5.70), q 6.8e-3 rad (9.4e-3); polish misses port 1/0/0/1, JAX
2/0/2/0 ticks in the four windows.

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_walk_windows.py
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from card_device import DEVICES, on
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.utils import tree
from quadruped_tpu_torch.utils.convert import flatten

# Small batches: one intra-op thread a process. torch would otherwise
# spread each op over every core, and the tier-1 run's six workers
# would oversubscribe the CPU (a whole-body test file: 55 s with the
# default threads alone, 35 s with one).
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "walk_a1.npz"
WINDOW, LEAD, RUNS = bench_walk.WINDOW, bench_walk.LEAD, bench_walk.WINDOW_RUNS
_checkpoints = bench_walk.checkpoints


def _jax_runs():
    """{checkpoint: (state dict, traces dict)} from the JAX package."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.walk_locomotion import (WalkConfig,
                                                       walk_init, walk_step)
    from quadruped_tpu.dynamics import floating_base as jfbm
    from quadruped_tpu.gait import WALK as JWALK
    from quadruped_tpu.gait.scheduler import _config
    from quadruped_tpu.gait.walk import SubLegState
    from quadruped_tpu.planner import foot_stepper as jfs
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import srb_sim as jsrb
    from quadruped_tpu.sim import terrain as jter
    from quadruped_tpu.sim import whole_body as jwb
    from quadruped_tpu_torch.utils.convert import as_numpy

    params = ja1()
    model = jfbm.build_model(params)
    cm = jwb.ContactModel()
    stair = jfs.StairParams(start_x=jnp.asarray(bench_walk.RISER_X),
                            width=jnp.asarray(5.0),
                            height=jnp.asarray(bench_walk.STEP_HEIGHT),
                            count=jnp.asarray(1))

    def stair_hook(target, feet):
        x_adj, _ = jfs.stair_foothold_adjust(feet[:, 0], stair,
                                             default_delta=0.1)
        return target.at[:, 0].set(x_adj)

    def gap_hook(target, feet):
        return target.at[:, 0].set(jfs.gap_foothold_adjust(
            target[:, 0], jnp.asarray([bench_walk.GAP_X]), bench_walk.GAP_W,
            margin=bench_walk.GAP_MARGIN, current_x=feet[:, 0]))

    terrains = {"flat": (None, None),
                "stair": (jter.stairs(step_length=5.0,
                                      step_height=bench_walk.STEP_HEIGHT,
                                      start_x=bench_walk.RISER_X - 5.0),
                          stair_hook),
                "gap": (jter.gaps(gap_centers=(bench_walk.GAP_X,),
                                  gap_width=bench_walk.GAP_W, depth=0.5),
                        gap_hook)}
    out = {}
    for run, (sim_kind, qp_iters, vx, events) in RUNS.items():
        terr, hook = terrains[run]
        gait = JWALK() if run == "flat" else _config(
            3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1)
        config = WalkConfig(gait=gait, force_balance=jfb.ForceBalanceConfig(
            kp=jnp.asarray(bench_walk.KP), kd=jnp.asarray(bench_walk.KD),
            qp_iters=qp_iters))

        def init(v, sim_kind=sim_kind, terr=terr, config=config):
            cmd = JTC.constant(vx=v, body_height=0.27)
            if sim_kind == "srb":
                sim0 = jsrb.srb_sim_init(params)
                obs0 = jsrb.observe(params, sim0, jnp.ones(4))
            else:
                sim0 = jwb.whole_body_init(params)
                obs0 = jwb.observe(params, model, sim0, cm,
                                   terrain_height=terr)
            return (sim0, walk_init(config, params, obs0)), cmd

        def scan_from(carry, cmd, start, steps, sim_kind=sim_kind,
                      terr=terr, hook=hook, config=config):
            def step(carry, i):
                sim, st = carry
                t = (i + 1).astype(jnp.float32) * bench_walk.DT
                if sim_kind == "srb":
                    sup = (st.gait.leg_sub_state
                           != SubLegState.TRUE_SWING).astype(jnp.float32)
                    obs = jsrb.observe(params, sim, sup)
                    command, forces, st_new = walk_step(config, params, st,
                                                        obs, cmd, t)
                    sn = (st_new.gait.leg_sub_state
                          != SubLegState.TRUE_SWING).astype(jnp.float32)
                    sim_new = jsrb.srb_sim_step(
                        params, sim, forces, sn, command.q, command.dq,
                        1.0 - jnp.repeat(sn, 3), bench_walk.DT)
                    position = sim_new.position
                else:
                    obs = jwb.observe(params, model, sim, cm,
                                      terrain_height=terr)
                    command, forces, st_new = walk_step(
                        config, params, st, obs, cmd, t,
                        terrain_height=terr, foothold_adjust_fn=hook)
                    sim_new, _ = jwb.whole_body_step(
                        params, model, sim, command, cm, bench_walk.DT,
                        terrain_height=terr)
                    position = sim_new.fb.position
                trace = {"position": position,
                         "sub_state": st_new.gait.leg_sub_state,
                         "forces": forces, "q_cmd": command.q}
                return (sim_new, st_new), ((sim, st), trace)

            return jax.lax.scan(step, carry, start + jnp.arange(steps))[1]

        vxs = jnp.asarray(vx, jnp.float32)
        cmds = jax.vmap(init)(vxs)[1]
        steps = max(events.values()) - LEAD + WINDOW
        states, traces = jax.jit(jax.vmap(
            lambda v: scan_from(*init(v), 0, steps)))(vxs)
        window = jax.jit(jax.vmap(
            lambda c, cmd, k: scan_from(c, cmd, k, WINDOW)[1]))
        for name, tick in events.items():
            k = tick - LEAD
            carry = jax.tree.map(lambda a: a[:, k], states)
            ks = jnp.full((len(vx),), k, jnp.int32)
            # The window again, restarted from the start height one float32
            # step up: how far JAX moves from its own run.
            sim_k, st_k = carry
            fbs = sim_k if sim_kind == "srb" else sim_k.fb
            nudged = fbs.replace(position=fbs.position.at[:, 2].set(
                jnp.nextafter(fbs.position[:, 2], jnp.inf)))
            sim_n = nudged if sim_kind == "srb" else sim_k.replace(fb=nudged)
            out[f"{run}_{name}"] = (
                {"sim": as_numpy(sim_k), "walk": as_numpy(st_k)},
                {key: np.asarray(v[:, k:k + WINDOW])
                 for key, v in traces.items()},
                {key: np.asarray(v)
                 for key, v in window((sim_n, st_k), cmds, ks).items()})
    return out


@functools.lru_cache(maxsize=None)
def _port_windows(device="cpu"):
    loops, rows = bench_walk.window_loops(np.load(FIXTURE), device)
    traces = {}
    for sim_kind, loop in loops.items():
        _, tr = bench_walk.run(loop, WINDOW, record=True)
        for key, run, kind, _ in _checkpoints():
            if kind == sim_kind:
                traces[key] = {k: v[rows[key]].cpu().numpy()
                               for k, v in tr.items()}
    return traces


def test_fixture_layout():
    data = np.load(FIXTURE)
    assert int(data["window"]) == WINDOW and int(data["lead"]) == LEAD
    for key, run, _, start in _checkpoints():
        np.testing.assert_array_equal(data[f"{key}/vx"],
                                      np.asarray(RUNS[run][2], np.float32))
        assert int(data[f"{key}/start"]) == start
        assert data[f"{key}/trace/sub_state"].shape == (4, WINDOW, 4)


@pytest.mark.parametrize("device", DEVICES)
def test_windows_match_jax(device):
    errors = bench_walk.window_errors(np.load(FIXTURE),
                                      _port_windows(on(device)))
    for key, errs in errors.items():
        for k, value in errs.items():
            if k != "missed":
                err, limit = value
                assert err <= limit, f"{key} {k}: {err} > {limit}"


def test_windows_cover_their_events():
    """Each window holds its event: the TRUE_SWING entry of the flat walk,
    the SQP replan (a new pose target), and FR's swing onto the riser and
    across the gap (its target past the riser / the far edge)."""
    port = _port_windows()
    sub = port["flat_swing"]["sub_state"][0]
    assert ((sub[1:] == 8) & (sub[:-1] != 8)).any()
    for key in ("stair_riser", "gap_edge"):
        sub = port[key]["sub_state"][0, :, 0]
        assert ((sub[1:] == 8) & (sub[:-1] != 8)).any(), key


def test_replan_window_runs_the_sqp(monkeypatch):
    """The SQP runs on the replan tick of the window and on no other."""
    from quadruped_tpu_torch.planner import pose_planner

    calls = []
    sqp = pose_planner.plan_target_pose_sqp
    monkeypatch.setattr(pose_planner, "plan_target_pose_sqp",
                        lambda *a, **k: calls.append(1) or sqp(*a, **k))
    loops, rows = bench_walk.window_loops(np.load(FIXTURE), "cpu")
    loop = loops["srb"]
    replan = rows["flat_replan"]
    loop = loop._replace(
        cmd=tree.index(loop.cmd, replan), sim=tree.index(loop.sim, replan),
        walk=tree.index(loop.walk, replan), start=loop.start[replan])
    bench_walk.run(loop, 2 * LEAD)
    assert len(calls) == 1, len(calls)


def _regenerate():
    arrays = {"window": np.int32(WINDOW), "lead": np.int32(LEAD)}
    runs = _jax_runs()
    for key, run, _, start in _checkpoints():
        state, traces, nudged = runs[key]
        arrays[f"{key}/vx"] = np.asarray(RUNS[run][2], np.float32)
        arrays[f"{key}/start"] = np.int32(start)
        arrays.update(flatten(state, f"{key}/state"))
        for k, v in traces.items():
            arrays[f"{key}/trace/{k}"] = (v.astype(np.int8)
                                          if k == "sub_state" else v)
            if k != "sub_state":
                arrays[f"{key}/nudged/{k}"] = nudged[k]
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    _regenerate()
