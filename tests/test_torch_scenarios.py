"""Heterogeneous fleets on the port against the JAX package (CPU).

* `stack_params` field by field against the JAX `stack_params` for all
  five robots, `scenario_grid` against the JAX grid (parameters, gait
  tables, commands, n), `tile_scenarios` against the JAX tiling, and
  `srb_continuous` / `srb_discretize` with a [B] mass and [B, 3, 3]
  inertia against `jax.vmap` of the JAX functions.
* The JAX tests/test_scenarios.py: `test_heterogeneous_fleet_rollout`
  (a1 / go1 / lite3 x vx 0, 0.3) and `test_multi_gait_batch` (a1 x trot /
  bound / pace), H=5, `qp_iters=30`, 150 ticks, the port's `rollout` held
  to `jax.vmap(rollout)` over the JAX `scenario_grid`: the first 24 ticks
  at tests/test_torch_rollout.py's limits (height 2e-4 m, velocity 5e-3
  m/s, forces 1% m*g of the A1); the whole window and the final joint
  angles
  at 10x JAX's own spread, the most the window moves when JAX runs it
  again from a start one float32 step off (base height up and down, a
  hip angle; `SPREAD_NUDGES`), with floors of 1e-5 m, 1e-4 m/s, 1% m*g
  and 1e-4 rad. CPU readings (port vs JAX / JAX's spread): the fleet
  height 5.1e-6 / 7.3e-6 m, velocity 1.2e-4 / 1.9e-4 m/s, forces 0.77 /
  0.76 N, final q 4.3e-5 / 6.7e-5 rad; the gaits 2.2e-6 / 4.1e-6 m,
  1.1e-4 / 1.7e-4 m/s, 0.51 / 0.53 N. The JAX test's own checks hold
  too: all alive, final heights within 0.06 m of each robot's body
  height. tests/data/fleet_a1.npz keeps JAX's run and spread of both
  grids (`benchmarks/fleet.py` FIXTURE): the live JAX run must still
  reproduce it, and the port must match it on the CPU and (marker
  `cuda`) on the card. Regenerate it only on purpose (~1 min of JAX):
      PYTHONPATH=. python tests/test_torch_scenarios.py
* One `locomotion_step` and `srb_sim_step` of a fleet (robots and gait
  tables cycling, vx and wz from a seed) from a mid-trot carry on an MPC
  solve tick, against each
  scenario run alone with its one-robot parameters, for B = 3, 4, 5 and
  12: the sizes at which a [B] field meeting a [B, 3], [B, 4] or [B, 12]
  tensor would broadcast over axes, legs or joints without an error.
  Equal to float32 rounding (CPU: bit for bit at B = 3, 4, 5; at B = 12
  the vectorised sine and arccosine of the swing IK differ in the last
  bit from their scalar tail, 1.2e-7 rad of q and 2.9e-6 rad/s of dq); a
  wrong broadcast is off by the difference between two robots.
* `rollout_cadenced` of the five robots at once against each alone.
* The cone QP a fleet hands the solver (K1 on the card): each row's force
  cap is its own robot's m*g on its stance steps, and with a friction
  coefficient of its own per row the batched solve equals `jax.vmap` of
  the JAX solve over the rows (tests/test_torch_cone_qp.py's limits).
* `to_torch` of a JAX `RolloutCarry` (its step counter an int) resumes
  the port's rollout where JAX's carry stands.
"""

import dataclasses

import numpy as np
import pytest
import torch

from card_device import DEVICES, on
from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_step)
from quadruped_tpu_torch.gait import named_gait
from quadruped_tpu_torch.gait.scheduler import GaitConfig, stance_contact_mask
from quadruped_tpu_torch.robots import named_params, stack_params
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim.rollout import (RolloutCarry, rollout,
                                             rollout_init, rollout_segment,
                                             tick_time)
from quadruped_tpu_torch.sim.scenario import (scenario_grid,
                                              tile_scenarios)
from quadruped_tpu_torch.utils import tree
from quadruped_tpu_torch.utils.convert import as_numpy, flatten, to_torch

torch.set_num_threads(1)

ROBOTS = ("a1", "go1", "aliengo", "lite3", "lite2")
MG = 13.0 * 9.81
STEPS = bench_fleet.FIXTURE_TICKS
GRIDS = bench_fleet.GRIDS
# (SrbSimState field, column, direction) of each one-float32-step nudge.
SPREAD_NUDGES = (("position", 2, 1.0), ("position", 2, -1.0), ("q", 1, 1.0))


def _np(x):
    return x.detach().cpu().numpy()


def _assert_fields_equal(port, ref, cls):
    for f in dataclasses.fields(cls):
        got = getattr(port, f.name)
        want = np.asarray(getattr(ref, f.name))
        assert got.dtype != torch.float64, f.name
        np.testing.assert_array_equal(_np(got), want, err_msg=f.name)


def test_stack_params_equal_jax():
    """All five robots, every field, exactly; the JAX stack converted by
    `to_torch` is the port's fleet form."""
    from quadruped_tpu.robots import stack_params as j_stack

    names = ROBOTS + ("a1",)
    port, ref = stack_params(names, "cpu"), j_stack(names)
    assert port.stacked and port.total_mass.shape == (6,)
    assert port.hip_offset.shape == (6, 4, 3)
    _assert_fields_equal(port, ref, RobotParams)
    np.testing.assert_array_equal(_np(port.max_force),
                                  np.asarray(ref.max_force))
    converted = to_torch(ref, RobotParams, device="cpu")
    assert converted.stacked
    for f in dataclasses.fields(RobotParams):
        assert torch.equal(getattr(converted, f.name),
                           getattr(port, f.name)), f.name
    for i, name in enumerate(names):
        one = named_params(name, "cpu")
        assert not one.stacked
        for f in dataclasses.fields(RobotParams):
            assert torch.equal(getattr(port, f.name)[i],
                               getattr(one, f.name)), (name, f.name)


@pytest.mark.parametrize("robots,gaits,vx,wz", [
    (("a1", "go1", "aliengo", "lite3"), ("trot",), (0.0, 0.2, 0.4, 0.6),
     (0.0,)),
    (("lite2", "a1"), ("trot", "bound", "pace", "walk"), (0.1, 0.5),
     (-0.3, 0.0, 0.3)),
])
def test_scenario_grid_equal_jax(robots, gaits, vx, wz):
    """Parameters, gait tables and commands in the JAX loop order."""
    from quadruped_tpu.sim.scenario import scenario_grid as j_grid

    p, g, c, n = scenario_grid(robots, gaits, vx, wz, body_height=0.28,
                               device="cpu")
    jp, jg, jc, jn = j_grid(robots, gaits, vx, wz, body_height=0.28)
    assert n == jn == len(robots) * len(gaits) * len(vx) * len(wz)
    _assert_fields_equal(p, jp, RobotParams)
    _assert_fields_equal(g, jg, GaitConfig)
    _assert_fields_equal(c, jc, TwistCommand)
    assert c.linear.shape == (n, 3) and g.duty_factor.shape == (n, 4)
    # The JAX stacked tables convert to the port's per-scenario form.
    _assert_fields_equal(to_torch(jg, GaitConfig, device="cpu"), jg,
                         GaitConfig)


def test_tile_scenarios_equal_jax():
    from quadruped_tpu.sim.scenario import scenario_grid as j_grid
    from quadruped_tpu.sim.scenario import tile_scenarios as j_tile

    grid = (("a1", "lite3"), ("trot", "pace"), (0.0, 0.3))
    p, g, c, n = scenario_grid(*grid, device="cpu")
    jp, jg, jc, _ = j_grid(*grid)
    tp, tg, tc = tile_scenarios((p, g, c), 3)
    jtp, jtg, jtc = j_tile((jp, jg, jc), 3)
    _assert_fields_equal(tp, jtp, RobotParams)
    _assert_fields_equal(tg, jtg, GaitConfig)
    _assert_fields_equal(tc, jtc, TwistCommand)
    assert tp.total_mass.shape == (3 * n,)
    assert torch.equal(tp.hip_offset[n + 1], p.hip_offset[1])


def test_srb_model_takes_stacked_mass_and_inertia():
    """[B] mass and [B, 3, 3] inertia against jax.vmap over the robots."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.dynamics import srb as jsrb
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu_torch.dynamics import srb

    rng = np.random.default_rng(1)
    b = len(ROBOTS)
    yaw = rng.uniform(-1, 1, b).astype(np.float32)
    feet = (rng.normal(size=(b, 4, 3)) * 0.04 + np.array(
        [[0.17, -0.13, -0.28], [0.17, 0.13, -0.28], [-0.17, -0.13, -0.28],
         [-0.17, 0.13, -0.28]])).astype(np.float32)
    jp = j_stack(ROBOTS)
    ja, jb = jax.vmap(jsrb.srb_continuous)(jnp.asarray(yaw),
                                           jp.total_inertia, jp.total_mass,
                                           jnp.asarray(feet))
    jad, jbd = jsrb.srb_discretize(ja, jb, 0.03)
    p = stack_params(ROBOTS, "cpu")
    a, bm = srb.srb_continuous(torch.from_numpy(yaw), p.total_inertia,
                               p.total_mass, torch.from_numpy(feet))
    ad, bd = srb.srb_discretize(a, bm, 0.03)
    for got, want in ((a, ja), (bm, jb), (ad, jad), (bd, jbd)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # Each row is its own robot: 1/m in the velocity rows.
    np.testing.assert_allclose(_np(bm[:, 9, 0]), 1.0 / _np(p.total_mass),
                               rtol=1e-6)


def _jax_runs(robots, gaits, vx):
    """jax.vmap(rollout) over the JAX grid and JAX's spread over the
    window: {key: array}, {key: spread}."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as jm, swing as js
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.sim.rollout import rollout as j_rollout
    from quadruped_tpu.sim.rollout import rollout_init as j_init
    from quadruped_tpu.sim.rollout import rollout_segment as j_segment
    from quadruped_tpu.sim.scenario import scenario_grid as j_grid

    jp, jg, jc, _ = j_grid(robots, gaits, vx)
    base = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=30),
               swing=js.SwingConfig(),
               gait=jax.tree.map(lambda x: x[0], jg))
    res = jax.jit(jax.vmap(lambda p, g, c: j_rollout(
        base.replace(gait=g), p, c, steps=STEPS)))(jp, jg, jc)

    def view(r):
        out = {k: np.asarray(getattr(r, k)) for k in
               ("base_height_trace", "vel_trace", "forces_trace", "alive")}
        out["q"] = np.asarray(r.sim.q)
        return out

    ref = view(res)
    carry = jax.jit(jax.vmap(lambda p, g: j_init(base.replace(gait=g),
                                                 p)))(jp, jg)
    seg = jax.jit(jax.vmap(lambda p, g, c, k: j_segment(
        base.replace(gait=g), p, c, k, STEPS)[1]))
    plain = view(seg(jp, jg, jc, carry))
    spread = dict.fromkeys(bench_fleet.FIXTURE_KEYS, 0.0)
    for field, col, way in SPREAD_NUDGES:
        leaf = getattr(carry.sim, field)
        moved = leaf.at[:, col].set(jnp.nextafter(leaf[:, col],
                                                  way * jnp.inf))
        again = view(seg(jp, jg, jc, carry._replace(
            sim=carry.sim.replace(**{field: moved}))))
        for k in spread:
            spread[k] = max(spread[k],
                            float(np.max(np.abs(again[k] - plain[k]))))
    return ref, spread, np.asarray(jp.body_height)


def _as_fixture(runs: dict) -> dict:
    """{case: (run, spread)} -> the fixture's arrays."""
    out = {}
    for case, (run, spread) in runs.items():
        out.update({f"{case}/{k}": v for k, v in run.items()})
        out.update({f"{case}/spread/{k}": np.float32(v)
                    for k, v in spread.items()})
    return out


def _assert_within(errors: dict, what: str):
    for k, (err, limit) in errors.items():
        assert err <= limit, f"{what} {k}: {err} > {limit}"


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_fleet_rollout_matches_jax(case):
    """Live: the port against jax.vmap(rollout), within the first 24 ticks
    and the window limits of JAX's live spread; JAX still reproduces the
    fixture; the JAX test's own checks."""
    ref, spread, body_height = _jax_runs(*GRIDS[case])
    live = _as_fixture({case: (ref, spread)})
    got = bench_fleet.fixture_run(case, "cpu")
    assert got["alive"].min() == 1.0
    _assert_within(bench_fleet.fixture_errors(got, live, case),
                   f"{case} port vs JAX")
    fixture = np.load(bench_fleet.FIXTURE)
    _assert_within(bench_fleet.fixture_errors(ref, fixture, case),
                   f"{case} JAX vs the fixture")
    np.testing.assert_allclose(got["base_height_trace"][:, -1], body_height,
                               atol=0.06)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_fleet_fixture(case, device):
    """The port against tests/data/fleet_a1.npz, on the CPU and on the
    card."""
    got = bench_fleet.fixture_run(case, on(device))
    _assert_within(bench_fleet.fixture_errors(
        got, np.load(bench_fleet.FIXTURE), case), case)


def _step_outputs(config, params, carry, cmd, t):
    obs = srb_sim.observe(params, carry.sim,
                          stance_contact_mask(carry.ctrl.gait))
    command, forces, ctrl = locomotion_step(config, params, carry.ctrl, obs,
                                            cmd, t)
    stance = stance_contact_mask(ctrl.gait)
    sim = srb_sim.srb_sim_step(
        params, carry.sim, forces, stance, command.q, command.dq,
        1.0 - torch.repeat_interleave(stance, 3, dim=-1), 0.002)
    return flatten({k: as_numpy(v) for k, v in dict(
        command=command, forces=forces, ctrl=ctrl, obs=obs,
        sim=sim).items()}, "")


@pytest.mark.parametrize("batch", [3, 4, 5, 12])
def test_fleet_step_equals_each_robot_alone(batch):
    names = [ROBOTS[i % len(ROBOTS)] for i in range(batch)]
    gaits = [("trot", "bound", "pace")[i % 3] for i in range(batch)]
    rng = np.random.default_rng(batch)
    cmd = TwistCommand.constant(
        vx=(0.1 + 0.4 * rng.random(batch)).astype(np.float32),
        wz=(0.2 * rng.standard_normal(batch)).astype(np.float32),
        device="cpu")

    def config(gait):
        return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5,
                                                      qp_iters=30),
                                swing=swing_mod.SwingConfig(), gait=gait)

    params = stack_params(names, "cpu")
    fleet_cfg = config(tree.stack([named_gait(g, "cpu") for g in gaits]))
    # 24 ticks in, so that the step below solves the MPC (cadence 8).
    carry, _ = rollout_segment(fleet_cfg, params, cmd,
                               rollout_init(fleet_cfg, params, batch), 24)
    assert int(carry.ctrl.mpc.iteration[0]) % 8 == 0
    t = np.float32(25) * np.float32(0.002)
    fleet = _step_outputs(fleet_cfg, params, carry, cmd,
                          tick_time(t, batch, "cpu"))
    for i in range(batch):
        alone = _step_outputs(config(named_gait(gaits[i], "cpu")),
                              named_params(names[i], "cpu"),
                              tree.index(carry, [i]), tree.index(cmd, [i]),
                              tick_time(t, 1, "cpu"))
        assert sorted(alone) == sorted(fleet)
        for k, v in alone.items():
            torch.testing.assert_close(
                torch.from_numpy(fleet[k][i:i + 1]), torch.from_numpy(v),
                msg=lambda m, k=k: f"scenario {i} ({names[i]}) {k}: {m}")


def test_fleet_cadenced_rollout_equals_each_robot_alone():
    """`rollout_cadenced` (one solve a period) of the five robots at once
    against each alone, over 3 periods."""
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                              swing=swing_mod.SwingConfig(),
                              gait=named_gait("advanced_trot", "cpu"))
    vx = np.linspace(0.1, 0.5, len(ROBOTS), dtype=np.float32)
    fleet = rollout_cadenced(config, stack_params(ROBOTS, "cpu"),
                             TwistCommand.constant(vx=vx, device="cpu"), 3)
    for i, name in enumerate(ROBOTS):
        alone = rollout_cadenced(config, named_params(name, "cpu"),
                                 TwistCommand.constant(vx=vx[i:i + 1],
                                                       device="cpu"), 3)
        for k in ("base_height_trace", "vel_trace", "alive"):
            torch.testing.assert_close(getattr(fleet, k)[i:i + 1],
                                       getattr(alone, k), msg=name)
        torch.testing.assert_close(fleet.sim.q[i:i + 1], alone.sim.q,
                                   msg=name)


def test_fleet_qp_rows_and_per_row_friction():
    """The cone QP of a fleet solve: per-row force caps, and a batched
    solve with a friction coefficient per row against jax.vmap of the JAX
    solve over the rows."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.solvers import cone_qp as jcq
    from quadruped_tpu_torch.solvers import cone_qp as tcq

    names = ROBOTS + ("aliengo", "a1", "go1")
    p = stack_params(names, "cpu")
    g = tree.stack([named_gait("trot", "cpu")] * len(names))
    cfg = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                           swing=swing_mod.SwingConfig(), gait=g)
    cmd = TwistCommand.constant(vx=0.3, batch=len(names), device="cpu")
    carry = rollout_init(cfg, p, len(names))
    captured = []
    solve = tcq.solve
    try:
        tcq.solve = lambda prob, **kw: captured.append(prob) or solve(prob,
                                                                      **kw)
        rollout_segment(cfg, p, cmd, carry, 1)
    finally:
        tcq.solve = solve
    prob = captured[0]
    caps = prob.fz_hi.reshape(len(names), -1)
    stance = caps > 0
    assert stance.any(1).all()
    np.testing.assert_array_equal(
        _np(caps), _np(stance * (p.total_mass * 9.81)[:, None]))
    np.testing.assert_array_equal(_np(prob.mu), _np(p.friction_coef))

    mu = torch.as_tensor(np.random.default_rng(2).uniform(
        0.3, 0.9, len(names)).astype(np.float32))
    mixed = dataclasses.replace(prob, mu=mu)
    kw = dict(iters=30, ns_f32_polish=2)
    sol = tcq.solve(mixed, **kw)

    def one(pm, q, m, lo, hi):
        s = jcq.solve(jcq.ConeQP(p=pm[None], q=q[None], mu=m, fz_lo=lo[None],
                                 fz_hi=hi[None]), **kw)
        return s.x[0], s.y[0]

    jx, jy = jax.jit(jax.vmap(one))(*(jnp.asarray(_np(v)) for v in (
        mixed.p, mixed.q, mixed.mu, mixed.fz_lo, mixed.fz_hi)))
    np.testing.assert_allclose(_np(sol.x), np.asarray(jx), atol=5e-2,
                               rtol=1e-3)
    np.testing.assert_allclose(_np(sol.y), np.asarray(jy), atol=5e-2,
                               rtol=1e-3)


def test_to_torch_resumes_a_jax_carry():
    """A JAX RolloutCarry (jax.vmap over a fleet) becomes the port's: its
    step an int, its fields the port's shapes; the port continues from
    it within test_torch_rollout.py's limits over 16 ticks."""
    import jax

    from quadruped_tpu.control import mpc as jm, swing as js
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.sim.rollout import rollout_init as j_init
    from quadruped_tpu.sim.rollout import rollout_segment as j_segment
    from quadruped_tpu.sim.scenario import scenario_grid as j_grid

    grid = (("go1", "aliengo"), ("trot",), (0.0, 0.4))
    jp, jg, jc, n = j_grid(*grid)
    base = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=30),
               swing=js.SwingConfig(),
               gait=jax.tree.map(lambda x: x[0], jg))
    jcarry = jax.jit(jax.vmap(lambda p, g: j_init(base.replace(gait=g),
                                                  p)))(jp, jg)
    jcarry, _ = jax.jit(jax.vmap(lambda p, g, c, k: j_segment(
        base.replace(gait=g), p, c, k, 8)))(jp, jg, jc, jcarry)
    jnext, jres = jax.jit(jax.vmap(lambda p, g, c, k: j_segment(
        base.replace(gait=g), p, c, k, 16)))(jp, jg, jc, jcarry)

    carry = to_torch(jcarry, RolloutCarry, device="cpu")
    assert carry.step == 8 and isinstance(carry.step, int)
    p, g, c, _ = scenario_grid(*grid, device="cpu")
    cfg = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                           swing=swing_mod.SwingConfig(), gait=g)
    fresh = rollout_init(cfg, p, n)
    for k, v in flatten(as_numpy(fresh), "").items():
        assert flatten(as_numpy(carry), "")[k].shape == v.shape, k
    nxt, res = rollout_segment(cfg, p, c, carry, 16)
    assert nxt.step == 24 == int(np.asarray(jnext.step)[0])
    np.testing.assert_allclose(_np(res.base_height_trace),
                               np.asarray(jres.base_height_trace), atol=2e-4)
    np.testing.assert_allclose(_np(res.vel_trace),
                               np.asarray(jres.vel_trace), atol=5e-3)
    np.testing.assert_allclose(_np(res.forces_trace),
                               np.asarray(jres.forces_trace), atol=0.01 * MG)


if __name__ == "__main__":
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    runs = {}
    for case, grid in GRIDS.items():
        ref, spread, _ = _jax_runs(*grid)
        runs[case] = (ref, spread)
        print(case, "spread", spread)
    bench_fleet.FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(bench_fleet.FIXTURE, **_as_fixture(runs))
    print("wrote", bench_fleet.FIXTURE, bench_fleet.FIXTURE.stat().st_size,
          "bytes")
