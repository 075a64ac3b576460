"""Fleets through the robot runner on the port (sensors -> estimators ->
FSM -> locomotion -> safe command), against the JAX package and against
each robot alone (CPU).

* The estimator path on the whole-body sim from the sitting boot
  (benchmarks/runner.py: base at 0.15 m, the sit-down angles, the FSM's
  STAND_UP ramp, sensor noise levels 0 / 1 from a numpy seed): the JAX
  package boots the fleet of benchmarks/fleet.py (A1, Go1, Aliengo,
  Lite3; `jax.vmap` of its `runner_init` over its `stack_params`) and
  runs BOOT_TICKS ticks; the port resumes from JAX's boot state carried
  across by `utils.convert.to_torch` (the `WholeBodySimState` and the
  `RunnerState` with its estimators, their fleet axis kept) with the
  same noise. FSM states and estimated contact flags equal tick for
  tick; the base position, the estimated position and velocity and the
  joint-angle commands within benchmarks/runner.py's FLOOR, the limits
  of tests/test_torch_runner.py's windows where JAX's own spread is below
  them (CPU readings beside BOOT_TOL below).
* The ground-truth path on the SRB sim in LOCOMOTION (the runner's MPC,
  K1 on the card) for the same fleet, GT_TICKS ticks, against `jax.vmap`
  of the JAX runner, at tests/test_torch_runner.py's GT_TOL (CPU readings
  beside it).
* One runner tick of a fleet (robots cycling, vx and sensor noise from a
  seed) on the whole-body sim with the estimators, against each scenario
  run with its one-robot parameters and model, at B = 3, 4, 5 and 12: a
  STAND_UP tick of the ramp from the sitting boot, and a LOCOMOTION tick
  that solves the MPC (K1's path on the card) from a carry whose FSM is
  in LOCOMOTION. Equal to float32 rounding (tests/test_torch_fleet_
  modes.py's method, each scenario read at its own row).
"""

import functools

import numpy as np
import pytest
import torch

from fleet_cases import (BATCHES, assert_rows_equal, cycle, flat, heights,
                         max_err)
from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.fsm import FsmState
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.exec import RunnerConfig, RunnerState, runner_step
from quadruped_tpu_torch.robots import named_params, stack_params
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

ROBOTS = bench_fleet.ROBOTS
DT = bench_runner.DT
BOOT_TICKS = 30
NOISE = (0.0, 1.0, 0.0, 1.0)
# benchmarks/runner.py FLOOR (CPU readings on the fleet).
BOOT_TOL = {"position": 1e-5,         # 1.5e-8 m
            "p_est": 1e-5,            # 1.5e-8 m
            "v_est": 1e-4,            # 7.5e-8 m/s
            "q_cmd": 1e-3}            # 0 rad
GT_TICKS = 80
# tests/test_torch_runner.py GT_TOL (CPU readings on the fleet).
GT_TOL = {"position": 1e-4,           # 2.1e-5 m
          "vel_world": 1e-3,          # 2.9e-4 m/s
          "q": 1e-3,                  # 2.1e-4 rad
          "forces": 1.28,             # 1.1 N (the Aliengo's m*g: 196 N)
          "command_q": 5e-4}          # 8.4e-5 rad


def _noise(ticks: int, batch: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (ticks, batch, bench_runner.NOISE_DIM)).astype(np.float32)


def _jax_runner_config(use_estimators: bool):
    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.estimation.container import EstimatorConfig
    from quadruped_tpu.estimation.velocity import VelocityEstimatorConfig
    from quadruped_tpu.exec import RunnerConfig as JRC
    from quadruped_tpu.gait import ADVANCED_TROT

    return JRC(
        locomotion=LocomotionConfig(
            mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
            swing=swing.SwingConfig(), gait=ADVANCED_TROT()),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=use_estimators)


@functools.lru_cache(maxsize=None)
def _jax_boot():
    """JAX's sitting boot of the fleet and BOOT_TICKS ticks of its runner
    on estimates: (sim, runner state, {key: [B, T, ...]})."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.core import se3 as jse3
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.estimation.container import RawSensors
    from quadruped_tpu.exec import runner_init, runner_step as jstep
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim import whole_body as jwb

    config = _jax_runner_config(True)
    cm = jwb.ContactModel()
    sigma = jnp.asarray(bench_runner.NOISE_SIGMA, jnp.float32)

    def boot(p):
        sim = jwb.whole_body_init(p, body_height=bench_runner.SIT_HEIGHT)
        sim = jwb.WholeBodySimState(fb=sim.fb.replace(q=p.sitdown_angles),
                                    t=sim.t)
        return sim, runner_init(config, p, jwb.observe(
            p, jfb.build_model(p), sim, cm))

    def window(p, sim, st, vx, h, level, noise):
        model = jfb.build_model(p)
        cmd = JTC.constant(vx=vx, body_height=h)

        def step(carry, n):
            sim, st, prev_v = carry
            truth = jwb.observe(p, model, sim, cm)
            r = jse3.quat_to_rotmat(truth.base_quat)
            acc_world = (truth.base_vel_world - prev_v) / DT \
                + jnp.asarray([0.0, 0.0, 9.81])
            scaled = (level * sigma) * n
            sensors = RawSensors(
                quat=truth.base_quat,
                acc_body=acc_world @ r + scaled[0:3],
                omega_body=truth.base_omega_body + scaled[3:6],
                joint_angles=truth.joint_angles + scaled[6:18],
                joint_velocities=truth.joint_velocities + scaled[18:30],
                foot_forces=truth.foot_forces)
            command, _, st, est = jstep(config, p, st, cmd, sensors=sensors)
            sim, _ = jwb.whole_body_step(p, model, sim, command, cm, DT)
            return (sim, st, truth.base_vel_world), {
                "position": sim.fb.position, "fsm": st.fsm.state,
                "contact": st.estimator.contact.is_contact,
                "v_est": est.base_vel_world, "p_est": est.base_position,
                "q_cmd": command.q}

        return jax.lax.scan(step, (sim, st, jnp.zeros(3)), noise)[1]

    jp = j_stack(ROBOTS)
    sim, st = jax.jit(jax.vmap(boot))(jp)
    traces = jax.jit(jax.vmap(window))(
        jp, sim, st, jnp.full(len(ROBOTS), 0.2, jnp.float32),
        jnp.asarray(heights(ROBOTS)), jnp.asarray(NOISE, jnp.float32),
        jnp.asarray(np.swapaxes(_noise(BOOT_TICKS, len(ROBOTS)), 0, 1)))
    return sim, st, {k: np.asarray(v) for k, v in traces.items()}


def _port_loop(params, sim, runner, vx, h, noise_level):
    """A benchmarks/runner.py loop of the fleet `params` from these states."""
    batch = len(vx)
    return bench_runner.Loop(
        bench_runner.default_config("cpu"), params, fb.build_model(params),
        wb.ContactModel(),
        TwistCommand.constant(vx=vx, body_height=h, device="cpu"), sim,
        runner, torch.zeros(batch, 3),
        torch.as_tensor(np.asarray(noise_level, np.float32)).expand(
            batch).clone(), None)


def test_fleet_runner_boot_matches_jax():
    jsim, jst, want = _jax_boot()
    sim = to_torch(jsim, wb.WholeBodySimState, device="cpu")
    runner = to_torch(jst, RunnerState, device="cpu")
    assert runner.estimator.velocity.cov.shape == (len(ROBOTS), 3, 3)
    loop = _port_loop(stack_params(ROBOTS, "cpu"), sim, runner,
                      np.full(len(ROBOTS), 0.2, np.float32),
                      heights(ROBOTS), NOISE)
    _, got = bench_runner.run(loop, BOOT_TICKS, record=True,
                              noise=torch.from_numpy(
                                  _noise(BOOT_TICKS, len(ROBOTS))))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("fsm", "contact"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["fsm"] == FsmState.STAND_UP).all()
    for key, tol in BOOT_TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert max_err(got[key], want[key]) <= tol, key


@functools.lru_cache(maxsize=None)
def _jax_gt():
    """The JAX runner on the SRB sim in LOCOMOTION for the fleet,
    GT_TICKS ticks (tests/test_torch_runner.py's ground-truth path)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.fsm import FsmState as JF
    from quadruped_tpu.exec import runner_init, runner_step as jstep
    from quadruped_tpu.gait.scheduler import stance_contact_mask
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim import srb_sim

    config = _jax_runner_config(False)

    def robot(p, vx, h):
        sim = srb_sim.srb_sim_init(p)
        st = runner_init(config, p, srb_sim.observe(p, sim, jnp.ones(4)))
        st = st.replace(fsm=st.fsm.replace(
            state=jnp.asarray(JF.LOCOMOTION, jnp.int32)))
        cmd = JTC.constant(vx=vx, body_height=h)

        def step(carry, _):
            sim, st = carry
            obs = srb_sim.observe(p, sim,
                                  stance_contact_mask(st.locomotion.gait))
            command, forces, st, _ = jstep(config, p, st, cmd,
                                           observation=obs)
            stance = stance_contact_mask(st.locomotion.gait)
            sim = srb_sim.srb_sim_step(p, sim, forces, stance, command.q,
                                       command.dq,
                                       1.0 - jnp.repeat(stance, 3), DT)
            return (sim, st), {"position": sim.position,
                               "vel_world": sim.vel_world, "q": sim.q,
                               "forces": forces, "command_q": command.q,
                               "fsm": st.fsm.state}

        return jax.lax.scan(step, (sim, st), jnp.arange(GT_TICKS))[1]

    out = jax.jit(jax.vmap(robot))(j_stack(ROBOTS),
                                   jnp.asarray(_gt_vx()),
                                   jnp.asarray(heights(ROBOTS)))
    return {k: np.asarray(v) for k, v in out.items()}


def _gt_vx() -> np.ndarray:
    return (0.15 + 0.15 * np.random.default_rng(6).random(len(ROBOTS))
            ).astype(np.float32)


def test_fleet_ground_truth_runner_matches_jax():
    from quadruped_tpu_torch.benchmarks.runner import srb_boot, srb_tick

    params = stack_params(ROBOTS, "cpu")
    config = RunnerConfig(
        locomotion=bench_runner.default_config("cpu").locomotion)
    sim, st = srb_boot(config, params, len(ROBOTS))
    cmd = TwistCommand.constant(vx=_gt_vx(), body_height=heights(ROBOTS),
                                device="cpu")
    rows = {k: [] for k in GT_TOL}
    rows["fsm"] = []
    for _ in range(GT_TICKS):
        sim, st, command, forces = srb_tick(config, params, sim, st, cmd)
        for key, v in (("position", sim.position),
                       ("vel_world", sim.vel_world), ("q", sim.q),
                       ("forces", forces), ("command_q", command.q),
                       ("fsm", st.fsm.state)):
            rows[key].append(v)
    got = {k: torch.stack(v, 1).numpy() for k, v in rows.items()}
    want = _jax_gt()
    np.testing.assert_array_equal(got["fsm"], want["fsm"])
    assert (got["fsm"] == FsmState.LOCOMOTION).all()
    for key, tol in GT_TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert max_err(got[key], want[key]) <= tol, key


def _tick(loop, params, n):
    """One runner tick of `loop` with `params` (the loop's own, or one
    robot's) and standard normals n [B, 30]."""
    loop = loop._replace(params=params, model=fb.build_model(params))
    raw, truth = bench_runner.sensors(loop, loop.sim, n)
    command, forces, runner, est = runner_step(loop.config, params,
                                               loop.runner, loop.cmd,
                                               sensors=raw)
    sim, flags = wb.whole_body_step(params, loop.model, loop.sim, command,
                                    loop.contact, DT)
    return flat(command=command, forces=forces, runner=runner, est=est,
                truth=truth, sim=sim, flags=flags)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("fsm", ["stand_up", "locomotion"])
def test_fleet_tick_equals_each_robot_alone(fsm, batch):
    names = cycle(batch)
    params = stack_params(names, "cpu")
    rng = np.random.default_rng(batch)
    vx = (0.15 + 0.15 * rng.random(batch)).astype(np.float32)
    level = (np.arange(batch) % 2).astype(np.float32)
    loop = bench_runner.build(batch, "cpu", noise=level, vx=vx,
                              params=params, body_height=heights(names),
                              stand=fsm == "locomotion")
    if fsm == "locomotion":
        # Standing at the nominal height in LOCOMOTION, 8 ticks in: the
        # tick below solves the MPC.
        loop, _ = bench_runner.run(loop, 8)
        assert (loop.runner.fsm.state == FsmState.LOCOMOTION).all()
        assert int(loop.runner.locomotion.mpc.iteration[0]) % 8 == 0
    else:
        loop, _ = bench_runner.run(loop, 3)
    n = torch.from_numpy(_noise(1, batch, seed=batch)[0])
    fleet = _tick(loop, params, n)
    alone = [_tick(loop, named_params(name, "cpu"), n) for name in names]
    assert_rows_equal(fleet, alone, names)
