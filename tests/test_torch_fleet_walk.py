"""Fleets in the statically-stable WALK on the port, on the SRB sim and on
the whole-body sim, against the JAX package and against each robot alone
(CPU).

* The JAX package boots a fleet of the five robots (`jax.vmap` of its
  `walk_init` over its `stack_params`, each robot standing at its own
  body height and commanded that height less 1 cm, vx from a seed; the
  3.7 s walk table and the stance gains of benchmarks/walk.py) and walks
  it for WINDOW ticks, the first of which replans the base pose with the
  SQP. The port resumes from JAX's boot state, carried across by
  `utils.convert.to_torch` (the sim state and the `WalkState` with their
  fleet axis), and walks the same ticks with stacked parameters, in two
  windows: from the boot (whose first tick replans the base pose with
  the SQP) and from tick 300 (across the first TRUE_SWING entry, tick
  308). Sub-states equal on every tick; the first tick of each window at
  the walk's one-tick limits (tests/test_torch_walk.py STEP_TOL), the
  window at the floors of the walk windows (benchmarks/walk.py FLOOR:
  base position 1e-5 m, joint-angle commands 1e-3 rad, forces 1% of the
  A1's m*g on the ticks where neither package's polish missed, at most
  MISS_SLACK more misses than JAX). CPU readings beside the limits
  below.
* One `walk_step` and sim step of a fleet (robots cycling, vx from a
  seed) from a mid-walk state, against each scenario run with its
  one-robot parameters, at B = 3, 4, 5 and 12, on both sims: equal to
  float32 rounding (tests/test_torch_fleet_modes.py's method, each
  scenario read at its own row).
"""

import functools

import numpy as np
import pytest
import torch

from fleet_cases import (BATCHES, ROBOTS, assert_rows_equal, cycle, flat,
                         heights, max_err)
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.walk_locomotion import (WalkState,
                                                         walk_init,
                                                         walk_step)
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait.walk import SubLegState
from quadruped_tpu_torch.robots import named_params, stack_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

SIMS = ("srb", "wb")
# Windows of the JAX walk the port resumes: from the boot (its first tick
# replans with the SQP) and from tick 300 (the first TRUE_SWING entry of
# the 3.7 s table is tick 308).
STARTS = (0, 300)
WINDOW = 12
DT = bench_walk.DT
# tests/test_torch_walk.py STEP_TOL on the first tick of a window (its
# "other" limit on the base position); CPU readings, the largest of the
# two windows, SRB / whole-body.
STEP_TOL = {"forces": 0.5,            # 0.035 / 0.055 N
            "q_cmd": 1e-5,            # 0 / 0 rad (no leg swings yet)
            "position": 5e-6}         # 1.9e-9 / 3.0e-8 m
# benchmarks/walk.py FLOOR over the window; CPU readings as above.
WINDOW_TOL = bench_walk.FLOOR         # forces 1.1 / 0.43 N, q_cmd 1.9e-6 /
#                                       2.8e-5 rad, position 3.9e-8 /
#                                       1.7e-6 m


def _vx(batch: int) -> np.ndarray:
    return (0.02 + 0.05 * np.random.default_rng(3).random(batch)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_walk(sim_kind: str):
    """JAX's boot state of the five-robot fleet (numpy pytrees) and its
    traces over WINDOW ticks: (sim, walk, {key: [B, T, ...]})."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control import walk_locomotion as jwl
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.dynamics import floating_base as jfbm
    from quadruped_tpu.gait.scheduler import _config
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim import srb_sim as jsrb
    from quadruped_tpu.sim import whole_body as jwb

    config = jwl.WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=jfb.ForceBalanceConfig(
            kp=jnp.asarray(bench_walk.KP), kd=jnp.asarray(bench_walk.KD),
            qp_iters=40))
    contact = jwb.ContactModel()

    def support(walk):
        return (walk.gait.leg_sub_state != SubLegState.TRUE_SWING).astype(
            jnp.float32)

    def observe(p, sim, sup):
        if sim_kind == "srb":
            return jsrb.observe(p, sim, sup)
        return jwb.observe(p, jfbm.build_model(p), sim, contact)

    def boot(p):
        sim = (jsrb.srb_sim_init(p) if sim_kind == "srb"
               else jwb.whole_body_init(p))
        return sim, jwl.walk_init(config, p, observe(p, sim, jnp.ones(4)))

    def window(p, sim, walk, v, h, start):
        cmd = JTC.constant(vx=v, body_height=h)

        def tick(carry, i):
            sim, walk = carry
            obs = observe(p, sim, support(walk))
            t = (i + 1).astype(jnp.float32) * DT
            command, forces, walk = jwl.walk_step(config, p, walk, obs, cmd,
                                                  t)
            if sim_kind == "srb":
                stance = support(walk)
                sim = jsrb.srb_sim_step(p, sim, forces, stance, command.q,
                                        command.dq,
                                        1.0 - jnp.repeat(stance, 3), DT)
                position = sim.position
            else:
                sim, _ = jwb.whole_body_step(p, jfbm.build_model(p), sim,
                                             command, contact, DT)
                position = sim.fb.position
            return (sim, walk), {"position": position, "forces": forces,
                                 "q_cmd": command.q,
                                 "sub_state": walk.gait.leg_sub_state}

        return jax.lax.scan(tick, (sim, walk), start + jnp.arange(WINDOW))

    jp = j_stack(ROBOTS)
    carry = jax.jit(jax.vmap(boot))(jp)
    run = jax.jit(jax.vmap(window, in_axes=(0, 0, 0, 0, 0, None)))
    out, tick = {}, 0
    while tick <= STARTS[-1]:
        state = carry
        carry, traces = run(jp, *carry, jnp.asarray(_vx(len(ROBOTS))),
                            jnp.asarray(heights(ROBOTS)), tick)
        if tick in STARTS:
            out[tick] = (jax.tree.map(np.asarray, state[0]),
                         jax.tree.map(np.asarray, state[1]),
                         {k: np.asarray(v) for k, v in traces.items()})
        tick += WINDOW
    return out


def _loop(sim_kind, params, sim, walk, vx, h, tick=0):
    """A benchmarks/walk.py loop on flat ground from these states at
    `tick`."""
    config = bench_walk.walk_config(bench_walk.walk_table("cpu"))
    cmd = TwistCommand.constant(vx=vx, body_height=h, device="cpu")
    start = np.full(len(vx), tick, np.int64)
    if sim_kind == "srb":
        return bench_walk.Loop(config, params, cmd, sim, walk, start)
    return bench_walk.Loop(config, params, cmd, sim, walk, start,
                           fb.build_model(params), wb.ContactModel())


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("sim_kind", SIMS)
def test_fleet_walk_matches_jax(sim_kind, start):
    jsim, jwalk, want = _jax_walk(sim_kind)[start]
    sim_cls = srb_sim.SrbSimState if sim_kind == "srb" \
        else wb.WholeBodySimState
    sim = to_torch(jsim, sim_cls, device="cpu")
    walk = to_torch(jwalk, WalkState, device="cpu")
    assert all(v.shape[0] == len(ROBOTS) for v in flat(
        sim=sim, walk=walk).values())
    loop = _loop(sim_kind, stack_params(ROBOTS, "cpu"), sim, walk,
                 _vx(len(ROBOTS)), heights(ROBOTS), start)
    _, got = bench_walk.run(loop, WINDOW, record=True)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["sub_state"], want["sub_state"])
    for key, tol in STEP_TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert max_err(got[key][:, :1], want[key][:, :1]) <= tol, key
    miss_port = bench_walk.missed(got["forces"])
    miss_jax = bench_walk.missed(want["forces"])
    assert miss_port.sum() <= miss_jax.sum() + bench_walk.MISS_SLACK
    held = ~(miss_port | miss_jax)
    err = np.abs(got["forces"] - want["forces"]).max((-1, -2))
    assert err[held].max() <= WINDOW_TOL["forces"]
    for key in ("q_cmd", "position"):
        assert max_err(got[key], want[key]) <= WINDOW_TOL[key], key


def _step(sim_kind, params, model, sim, walk, cmd, t):
    config = bench_walk.walk_config(bench_walk.walk_table("cpu"))
    if sim_kind == "srb":
        obs = srb_sim.observe(params, sim, bench_walk.support_mask(walk))
        command, forces, walk = walk_step(config, params, walk, obs, cmd, t)
        stance = bench_walk.support_mask(walk)
        sim = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq,
            1.0 - torch.repeat_interleave(stance, 3, dim=-1), DT)
    else:
        obs = wb.observe(params, model, sim, wb.ContactModel())
        command, forces, walk = walk_step(config, params, walk, obs, cmd, t)
        sim, _ = wb.whole_body_step(params, model, sim, command,
                                    wb.ContactModel(), DT)
    return flat(command=command, forces=forces, walk=walk, obs=obs, sim=sim)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("sim_kind", SIMS)
def test_fleet_step_equals_each_robot_alone(sim_kind, batch):
    names = cycle(batch)
    params = stack_params(names, "cpu")
    rng = np.random.default_rng(batch)
    vx = (0.02 + 0.05 * rng.random(batch)).astype(np.float32)
    h = heights(names)
    if sim_kind == "srb":
        sim = srb_sim.srb_sim_init(params, batch)
        obs = srb_sim.observe(params, sim, torch.ones(batch, 4))
    else:
        sim = wb.whole_body_init(params, batch)
        obs = wb.observe(params, fb.build_model(params), sim,
                         wb.ContactModel())
    config = bench_walk.walk_config(bench_walk.walk_table("cpu"))
    loop = _loop(sim_kind, params, sim, walk_init(config, params, obs), vx,
                 h)
    loop, _ = bench_walk.run(loop, 3)
    cmd = loop.cmd
    t = torch.full((batch,), float(np.float32(4) * np.float32(DT)))
    model = loop.model
    fleet = _step(sim_kind, params, model, loop.sim, loop.walk, cmd, t)
    alone = []
    for name in names:
        one = named_params(name, "cpu")
        alone.append(_step(sim_kind, one, None if model is None
                           else fb.build_model(one), loop.sim, loop.walk,
                           cmd, t))
    assert_rows_equal(fleet, alone, names)

