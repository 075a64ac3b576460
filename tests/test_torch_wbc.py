"""The port's whole-body controller (control/wbc.py) and the `use_wbc`
closed loop against the JAX package.

* `damped_pinv`, `build_tasks`, `multitask_projection`, `wbic_torque` and
  `wbc_step` on B = 8 states drawn as the JAX benchmarks/bench_wbc.py draws
  them (stand angles + N(0, 0.05), joint speeds N(0, 0.2), default_rng(0)),
  with swing legs on half of them, port against JAX on the same inputs.
  The damped pseudo-inverses are where two float32 implementations could
  part: `damped_pinv` adds lam^2 = 1e-6 to J J^T, `_weighted_pinv` 1e-4 to
  J A^-1 J^T after `inv_spd` of the 18 x 18 mass matrix. So the cascades
  are also held, port and JAX alike, to a float64 run of the port; the two
  float32 results lie as far from it as from each other (PIECE_TOL and
  WBC_TOL give each limit with the readings on this CPU: port vs JAX, port
  vs float64, JAX vs float64). Rows that the contact mask zeroes are
  exactly zero columns of the pseudo-inverse.
* `rollout` with `use_wbc=True` (4 scenarios, `MpcConfig(horizon=5,
  qp_iters=40)`, `WbcConfig()`, 200 ticks) against a JAX loop that runs
  the JAX `rollout_segment` tick by tick and keeps the commands' torques
  too, and against the fixture tests/data/rollout_wbc_a1.npz (that JAX
  output, with the JAX `wbc_step` outputs of the bench_wbc states, which
  chip_smoke.py holds the card to). The SRB sim does not apply the
  feed-forward torques, so the WBC shows in `tau_trace` only; its sim
  fields are held as tests/test_torch_rollout.py holds them, forces within
  1% m*g (measured 0.37 N), torques within 0.3 N m (measured 0.10).
* The WBC runs on the expected ticks (every 2nd, never on an MPC solve),
  changes the torques of the MPC-only run there and nowhere else, and the
  twins of the JAX checks tests/test_wbc.py and the WBC trot of
  tests/test_locomotion_modes.py on the port.

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_wbc.py
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
from quadruped_tpu_torch.control import locomotion as loco
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control import wbc
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg, se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params, kinematics
from quadruped_tpu_torch.sim import rollout as rollout_mod
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils.convert import to_torch

FIXTURE = Path(__file__).parent / "data" / "rollout_wbc_a1.npz"
B = 8
MG = 13.0 * 9.81
VX = [0.1, 0.25, 0.4, 0.55]
TICKS = 200
TRACE_STRIDE = 5
SIM_FIELDS = ("position", "quat", "vel_world", "omega_world", "q", "dq",
              "foot_anchor")
# As tests/test_torch_rollout.py, plus forces and torques.
TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
       "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
       "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-4,
       "forces_trace": 0.01 * MG, "tau_trace": 0.3}
# Measured over the 200 ticks: position 1.1e-5 (so the touchdown anchors
# 1.3e-5), height 2.8e-6, quat 1.3e-5, vel 1.1e-4, omega 1.1e-3, q 4.3e-5,
# dq 1.2e-3, forces 0.37 N, torques 0.10 N m.
# wbc_step outputs, port vs JAX and each vs the port in float64.
WBC_TOL = {"q_des": 1e-4, "dq_des": 5e-4, "tau": 2e-3}
# Measured (vs JAX / port vs f64 / JAX vs f64): q_des 9.8e-6 / 1.6e-5 /
# 2.5e-5; dq_des 5.7e-5 / 7.0e-5 / 1.3e-4; tau 3.9e-4 / 2.9e-4 / 2.5e-4.
# The pieces on the same inputs, as above.
PIECE_TOL = {"pinv": 1e-5, "tasks": 5e-5,
             "delta_q": 2e-4, "qdot": 1e-3,
             "tau": 2e-3, "qddot": 2e-2, "fr_total": 1e-2}
# Measured: pinv <= 1e-5 (held at the limit below), tasks 7.6e-6;
# delta_q 2.2e-5 / 2.3e-5 / 2.5e-5; qdot 1.3e-4 / 1.1e-4 / 1.3e-4;
# tau 5.3e-4 / 4.2e-4 / 2.5e-4; qddot 2.0e-3 / 4.2e-3 / 2.2e-3 (of 83);
# fr_total 2.3e-3 / 2.0e-3 / 1.1e-3 (of 33 N).


def _jax_bench():
    """The JAX benchmarks/bench_wbc.py module, imported with the JAX
    compilation-cache settings of this process kept as they were."""
    import importlib
    import sys

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "benchmarks"))
    try:
        return importlib.import_module("bench_wbc")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _contacts():
    """[B, 4] stance masks: all four legs, the two trot pairs, and one or
    three legs."""
    cs = np.ones((B, 4), np.float32)
    cs[1] = [1, 0, 0, 1]
    cs[3] = [0, 1, 1, 0]
    cs[5] = [1, 0, 0, 0]
    cs[7] = [0, 1, 1, 1]
    return cs


@functools.lru_cache(maxsize=None)
def _jax_inputs():
    """The JAX bench_wbc states at B = 8 with the swing masks of
    `_contacts` (JAX obs, cmd), and the JAX params and model."""
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.robots import a1_params as ja1

    _, (obs, cmd) = _jax_bench().build(B)
    cmd = cmd.replace(contact_state=jnp.asarray(_contacts()))
    params = ja1()
    return obs, cmd, params, jfb.build_model(params)


def _port_inputs():
    obs, cmd, _, _ = _jax_inputs()
    params = a1_params("cpu")
    return (to_torch(obs, RobotObservation), to_torch(cmd, wbc.WbcCommand),
            params, fb.build_model(params))


def _jax_state(obs):
    from quadruped_tpu.dynamics import floating_base as jfb

    return jfb.FbState(quat=obs.base_quat, position=obs.base_position,
                       omega_body=obs.base_omega_body,
                       vel_body=obs.base_vel_world @ obs.rot_body_to_world,
                       q=obs.joint_angles, dq=obs.joint_velocities)


def _port_state(obs):
    return fb.FbState(quat=obs.base_quat, position=obs.base_position,
                      omega_body=obs.base_omega_body,
                      vel_body=torch.einsum("bi,bij->bj", obs.base_vel_world,
                                            obs.rot_body_to_world),
                      q=obs.joint_angles, dq=obs.joint_velocities)


# ------------------------------------------------------- the pieces

def _f64(obj):
    """A dataclass of tensors in float64."""
    return type(obj)(**{f.name: getattr(obj, f.name).double()
                        for f in dataclasses.fields(obj)})


def test_bench_states_equal_jax():
    """The benchmark twin draws the JAX benchmark's states exactly."""
    _, (jobs, jcmd) = _jax_bench().build(B)
    _, (obs, cmd) = bench_wbc.build(B, device="cpu")
    for port, ref in ((obs, jobs), (cmd, jcmd)):
        for f in dataclasses.fields(port):
            np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)),
                                          err_msg=f.name)


def test_damped_pinv_matches_jax_and_zero_rows():
    """Wide matrices [8, 3, 18] and [8, 12, 18] with masked (all-zero)
    rows: port vs JAX, and the masked rows' columns exactly zero."""
    from quadruped_tpu.core import linalg as jlinalg

    rng = np.random.default_rng(1)
    for rows in (3, 12):
        j = rng.normal(size=(B, rows, 18)).astype(np.float32)
        mask = (rng.random((B, rows)) > 0.3).astype(np.float32)
        j = j * mask[..., None]
        want = jax.jit(jlinalg.damped_pinv, static_argnums=1)(
            jnp.asarray(j), 1e-3)
        got = linalg.damped_pinv(torch.as_tensor(j), 1e-3)
        assert _max_err(got, want) <= PIECE_TOL["pinv"]
        zero_cols = got.transpose(-1, -2)[torch.as_tensor(mask) == 0]
        assert zero_cols.numel() and torch.all(zero_cols == 0)


def test_build_tasks_matches_jax():
    from quadruped_tpu.control import wbc as jwbc

    jobs, jcmd, _, jmodel = _jax_inputs()
    want = jax.jit(jax.vmap(lambda o, c: jwbc.build_tasks(
        jwbc.WbcConfig(), jmodel, _jax_state(o), c)))(jobs, jcmd)
    obs, cmd, _, model = _port_inputs()
    got = wbc.build_tasks(wbc.WbcConfig(), model, _port_state(obs), cmd)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _max_err(g, w) <= PIECE_TOL["tasks"]


def test_multitask_projection_matches_jax():
    """Both on the JAX tasks; the contact rows of swing legs masked."""
    from quadruped_tpu.control import wbc as jwbc

    jobs, jcmd, _, jmodel = _jax_inputs()

    def one(o, c):
        jts, _, errs, vels, _, jc, _, _ = jwbc.build_tasks(
            jwbc.WbcConfig(), jmodel, _jax_state(o), c)
        jc_st = jc.reshape(12, 18) * jnp.repeat(c.contact_state, 3)[:, None]
        return (jts, errs, vels, jc_st), jwbc.multitask_projection(
            jts, errs, vels, jc_st)

    args, want = jax.jit(jax.vmap(one))(jobs, jcmd)
    args = [torch.as_tensor(np.array(a)) for a in args]
    got = wbc.multitask_projection(*args)
    f64 = wbc.multitask_projection(*(a.double() for a in args))
    for name, g, w, x in zip(("delta_q", "qdot"), got, want, f64):
        for a, b in ((g, w), (g, x), (w, x)):
            assert _max_err(a, b) <= PIECE_TOL[name], name


def test_wbic_torque_matches_jax():
    from quadruped_tpu.control import wbc as jwbc

    jobs, jcmd, jparams, jmodel = _jax_inputs()

    def one(o, c):
        st = _jax_state(o)
        jts, jdqds, _, _, accs, jc, jcdqd, _ = jwbc.build_tasks(
            jwbc.WbcConfig(), jmodel, st, c)
        return (jts, jdqds, accs, jc, jcdqd), jwbc.wbic_torque(
            jwbc.WbcConfig(), jparams, jmodel, st, c, jts, jdqds, accs, jc,
            jcdqd)

    args, want = jax.jit(jax.vmap(one))(jobs, jcmd)
    args = [torch.as_tensor(np.array(a)) for a in args]
    obs, cmd, params, model = _port_inputs()
    state = _port_state(obs)
    got = wbc.wbic_torque(wbc.WbcConfig(), params, model, state, cmd, *args)
    f64 = wbc.wbic_torque(wbc.WbcConfig(), _f64(params), _f64(model),
                          _f64(state), _f64(cmd), *(a.double() for a in args))
    for name, g, w, x in zip(("tau", "qddot", "fr_total"), got, want, f64):
        for a, b in ((g, w), (g, x), (w, x)):
            assert _max_err(a, b) <= PIECE_TOL[name], name
    # Swing legs get no reaction force.
    fr = got[2].reshape(B, 4, 3)
    swing = torch.as_tensor(_contacts()) == 0
    assert fr[swing].abs().max() <= 1e-2


@functools.lru_cache(maxsize=None)
def _wbc_step_runs():
    """wbc_step outputs: JAX, the port, the port in float64."""
    from quadruped_tpu.control import wbc as jwbc

    jobs, jcmd, jparams, jmodel = _jax_inputs()
    want = jax.jit(jax.vmap(lambda o, c: jwbc.wbc_step(
        jwbc.WbcConfig(), jparams, jmodel, o, c)))(jobs, jcmd)
    obs, cmd, params, model = _port_inputs()
    got = wbc.wbc_step(wbc.WbcConfig(), params, model, obs, cmd)
    f64 = wbc.wbc_step(wbc.WbcConfig(), _f64(params), _f64(model), _f64(obs),
                       _f64(cmd))
    names = ("q_des", "dq_des", "tau")
    return ({n: np.asarray(w) for n, w in zip(names, want)},
            {n: g.numpy() for n, g in zip(names, got)},
            {n: x.numpy() for n, x in zip(names, f64)})


@pytest.mark.parametrize("name", ["q_des", "dq_des", "tau"])
def test_wbc_step_matches_jax_and_float64(name):
    want, got, f64 = _wbc_step_runs()
    assert np.all(np.isfinite(got[name]))
    assert _max_err(got[name], want[name]) <= WBC_TOL[name]
    assert _max_err(got[name], f64[name]) <= WBC_TOL[name]
    assert _max_err(want[name], f64[name]) <= WBC_TOL[name]


# ------------------------------------------------- the use_wbc loop

def _port_config(use_wbc=True):
    return loco.LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT("cpu"),
        wbc=wbc.WbcConfig() if use_wbc else None, use_wbc=use_wbc)


def _summary(res_sim, alive, h, v, f, tau):
    out = {k: np.asarray(getattr(res_sim, k)) for k in SIM_FIELDS}
    out.update(alive=np.asarray(alive), base_height_trace=np.asarray(h),
               vel_trace=np.asarray(v), forces_trace=np.asarray(f),
               tau_trace=np.asarray(tau))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX rollout with use_wbc, tick by tick as its rollout_segment
    runs it, keeping each tick's hybrid-command torques."""
    from quadruped_tpu.control import mpc as jm
    from quadruped_tpu.control import swing as js
    from quadruped_tpu.control import wbc as jwbc
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import (LocomotionConfig as JLC,
                                                  locomotion_step)
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.gait import ADVANCED_TROT as JAT
    from quadruped_tpu.gait.scheduler import stance_contact_mask
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import srb_sim
    from quadruped_tpu.sim.rollout import _tip_over, rollout_init

    params = ja1()
    cfg = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=40),
              swing=js.SwingConfig(), gait=JAT(), wbc=jwbc.WbcConfig(),
              use_wbc=True)

    def one(vx):
        cmd = JTC.constant(vx=vx, body_height=0.27)
        carry = rollout_init(cfg, params)
        model = jfb.build_model(params)

        def step(c, i):
            sim, ctrl, dead = c
            t = (i + 1).astype(jnp.float32) * 0.002
            obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
            command, forces, ctrl = locomotion_step(cfg, params, ctrl, obs,
                                                    cmd, t, model=model)
            stance = stance_contact_mask(ctrl.gait)
            sim_new = srb_sim.srb_sim_step(
                params, sim, forces, stance, command.q, command.dq,
                1.0 - jnp.repeat(stance, 3), 0.002)
            dead = jnp.maximum(dead, _tip_over(sim_new))
            sim_new = jax.tree.map(lambda n, o: jnp.where(dead > 0.5, o, n),
                                   sim_new, sim)
            return (sim_new, ctrl, dead), (sim_new.position[2],
                                           sim_new.vel_world, forces,
                                           command.tau)

        (sim, _, dead), traces = jax.lax.scan(
            step, (carry.sim, carry.ctrl, carry.dead), jnp.arange(TICKS))
        return sim, 1.0 - dead, traces

    sim, alive, traces = jax.jit(jax.vmap(one))(jnp.asarray(VX, jnp.float32))
    return _summary(sim, alive, *traces)


@functools.lru_cache(maxsize=None)
def _port_run(use_wbc=True):
    """The port's rollout, with the sequence of MPC solves, WBC calls and
    ticks it made."""
    events = []
    originals = (mpc_mod.mpc_solve, wbc.wbc_step,
                 rollout_mod.locomotion_step)

    def logged(tag, fn):
        def run(*a, **kw):
            events.append(tag)
            return fn(*a, **kw)
        return run

    mpc_mod.mpc_solve = logged("solve", originals[0])
    wbc.wbc_step = logged("wbc", originals[1])
    rollout_mod.locomotion_step = logged("tick", originals[2])
    try:
        res = rollout_mod.rollout(
            _port_config(use_wbc), a1_params("cpu"),
            TwistCommand.constant(vx=np.asarray(VX, np.float32),
                                  body_height=0.27, device="cpu"), TICKS)
    finally:
        (mpc_mod.mpc_solve, wbc.wbc_step,
         rollout_mod.locomotion_step) = originals
    out = _summary(res.sim, res.alive, res.base_height_trace, res.vel_trace,
                   res.forces_trace, res.tau_trace)
    return out, tuple(events)


def _ticks_of(events, tag):
    """The tick indices on which `tag` happened (the boot solve is -1)."""
    tick, out = -1, []
    for e in events:
        if e == "tick":
            tick += 1
        elif e == tag:
            out.append(tick)
    return out


def _fixture_view(run):
    out = {k: run[k] for k in SIM_FIELDS + ("alive", "forces_trace",
                                            "tau_trace")}
    for key in ("base_height_trace", "vel_trace"):
        out[key] = run[key][:, TRACE_STRIDE - 1::TRACE_STRIDE]
    return out


def _assert_close(got, want):
    np.testing.assert_array_equal(got["alive"], want["alive"])
    for key, tol in TOL.items():
        assert np.all(np.isfinite(got[key])), key
        err = _max_err(got[key], want[key])
        assert err <= tol, f"{key}: max |diff| {err} > {tol}"


def test_wbc_rollout_matches_jax():
    got, _ = _port_run()
    _assert_close(got, _jax_run())
    assert np.all(got["alive"] == 1.0)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_fixture(side):
    """JAX still reproduces the fixture, and the port matches it."""
    data = dict(np.load(FIXTURE))
    np.testing.assert_array_equal(data["vx"], np.asarray(VX, np.float32))
    assert int(data["ticks"]) == TICKS
    assert int(data["trace_stride"]) == TRACE_STRIDE
    run = _jax_run() if side == "jax" else _port_run()[0]
    _assert_close(_fixture_view(run), data)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_wbc_tick_fixture(side):
    """wbc_step on the bench_wbc states (B = 8, four contacts): JAX still
    gives the fixture's outputs, and the port matches them."""
    data = np.load(FIXTURE)
    if side == "jax":
        step, args = _jax_bench().build(B)
        outs = [np.asarray(o) for o in step(*args)]
    else:
        step, args = bench_wbc.build(B, device="cpu")
        outs = [o.numpy() for o in step(*args)]
    for name, out in zip(("q_des", "dq_des", "tau"), outs):
        assert _max_err(out, data[f"wbc_tick_{name}"]) <= WBC_TOL[name]


def test_wbc_runs_on_the_expected_ticks():
    """Every 2nd tick, never on a tick that solves the MPC: the MPC solves
    every 8th tick from tick 0 (and once at boot), so the WBC runs on the
    even ticks that are not multiples of 8."""
    _, events = _port_run()
    solves = _ticks_of(events, "solve")
    wbc_ticks = _ticks_of(events, "wbc")
    assert solves == [-1] + list(range(0, TICKS, 8))
    assert wbc_ticks == [i for i in range(TICKS) if i % 2 == 0 and i % 8]
    assert not set(solves) & set(wbc_ticks)


def test_wbc_changes_the_torques_of_its_ticks_only():
    """The SRB sim does not apply tau, so the trajectories of the WBC run
    and the MPC-only run are the same: the torques are equal on the ticks
    without the WBC and differ on the WBC's ticks."""
    with_wbc, events = _port_run(True)
    mpc_only, _ = _port_run(False)
    np.testing.assert_array_equal(with_wbc["base_height_trace"],
                                  mpc_only["base_height_trace"])
    wbc_ticks = np.asarray(_ticks_of(events, "wbc"))
    other = np.setdiff1d(np.arange(TICKS), wbc_ticks)
    np.testing.assert_array_equal(with_wbc["tau_trace"][:, other],
                                  mpc_only["tau_trace"][:, other])
    diff = np.abs(with_wbc["tau_trace"][:, wbc_ticks]
                  - mpc_only["tau_trace"][:, wbc_ticks])
    assert diff.max() > 0.5, diff.max()


def test_no_model_no_wbc():
    """Without the model the use_wbc tick is the MPC tick (as in JAX)."""
    params = a1_params("cpu")
    cmd = TwistCommand.constant(vx=0.3, batch=2, device="cpu")
    outs = []
    for cfg in (_port_config(True), _port_config(False)):
        carry = rollout_mod.rollout_init(cfg, params, 2)
        obs = srb_sim.observe(params, carry.sim, torch.ones(2, 4))
        command, _, _ = loco.locomotion_step(
            cfg, params, carry.ctrl, obs, cmd,
            rollout_mod.tick_time(0.004, 2, "cpu"))
        outs.append(command.tau)
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------- twins of the JAX checks

def _make_obs(params, q=None, height=0.28):
    q = params.stand_angles[None] if q is None else q
    z3 = torch.zeros(1, 3)
    return RobotObservation(
        base_position=torch.tensor([[0.0, 0.0, height]]), base_rpy=z3,
        base_quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]]), base_vel_world=z3,
        base_omega_world=z3, base_omega_body=z3, joint_angles=q,
        joint_velocities=torch.zeros(1, 12), foot_contact=torch.ones(1, 4),
        foot_forces=torch.full((1, 4), 30.0))


def _stand_command(params, obs, contact=None):
    foot_base = kinematics.foot_positions_in_base_frame(params,
                                                        obs.joint_angles)
    contact = torch.ones(1, 4) if contact is None else contact
    weight = float(params.total_mass) * 9.81
    fr = torch.tensor([0.0, 0.0, weight / 4]).expand(1, 4, 3) \
        * contact[..., None]
    z3 = torch.zeros(1, 3)
    return wbc.WbcCommand(
        p_body_des=obs.base_position, v_body_des=z3, a_body_des=z3,
        rpy_des=z3, omega_des_world=z3,
        p_foot_des=foot_base + obs.base_position[:, None, :],
        v_foot_des=torch.zeros(1, 4, 3), a_foot_des=torch.zeros(1, 4, 3),
        fr_des=fr, contact_state=contact)


def _rest_state(obs):
    z3 = torch.zeros(1, 3)
    return fb.FbState(quat=obs.base_quat, position=obs.base_position,
                      omega_body=z3, vel_body=z3, q=obs.joint_angles,
                      dq=torch.zeros(1, 12))


def test_stand_equilibrium_torques():
    """Standing on target with forces balancing gravity: the WBIC torque
    is the static (G - Jc^T F)[6:] within 2.5 N m."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    obs = _make_obs(params)
    cmd = _stand_command(params, obs)
    _, _, tau = wbc.wbc_step(wbc.WbcConfig(), params, model, obs, cmd)
    assert torch.isfinite(tau).all()
    state = _rest_state(obs)
    jc, _, _ = fb.contact_jacobians(model, state)
    tau_static = (fb.gravity_force(model, state)
                  - torch.einsum("blji,blj->bi", jc, cmd.fr_des))[:, 6:]
    np.testing.assert_allclose(tau.numpy(), tau_static.numpy(), atol=2.5)


def test_swing_leg_gets_no_reaction_force():
    params = a1_params("cpu")
    model = fb.build_model(params)
    obs = _make_obs(params)
    cmd = _stand_command(params, obs, torch.tensor([[1.0, 0.0, 0.0, 1.0]]))
    state = _rest_state(obs)
    jts, jdqds, _, _, accs, jc, jcdqd, _ = wbc.build_tasks(
        wbc.WbcConfig(), model, state, cmd)
    _, _, fr_total = wbc.wbic_torque(wbc.WbcConfig(), params, model, state,
                                     cmd, jts, jdqds, accs, jc, jcdqd)
    fr = fr_total.reshape(4, 3).numpy()
    np.testing.assert_allclose(fr[1], 0.0, atol=1e-2)
    np.testing.assert_allclose(fr[2], 0.0, atol=1e-2)
    for leg in (0, 3):
        fz = fr[leg, 2]
        assert -1e-2 <= fz <= float(params.total_mass) * 9.81 + 1.0
        assert abs(fr[leg, 0]) <= 0.4 * fz + 0.05
        assert abs(fr[leg, 1]) <= 0.4 * fz + 0.05


def test_kinematic_pass_tracks_height_error():
    """2 cm below target: the kinematic cascade lowers the feet relative to
    the base."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    obs = _make_obs(params, height=0.26)
    cmd = dataclasses.replace(_stand_command(params, obs),
                              p_body_des=torch.tensor([[0.0, 0.0, 0.28]]))
    q_des, _, _ = wbc.wbc_step(wbc.WbcConfig(), params, model, obs, cmd)
    p0 = kinematics.foot_positions_in_base_frame(params, obs.joint_angles)
    p1 = kinematics.foot_positions_in_base_frame(params, q_des)
    assert torch.all(p1[0, :, 2] < p0[0, :, 2] + 1e-5)


def test_flight_phase_tracks_body_accel():
    """No contacts: the cascade's qddot realizes the body-position task's
    acceleration (the JAX check, with its plain matrix inverse of A)."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    obs = _make_obs(params, height=0.5)
    cmd = _stand_command(params, obs, torch.zeros(1, 4))
    cmd = dataclasses.replace(cmd, p_body_des=obs.base_position
                              + torch.tensor([[0.0, 0.0, 0.1]]))
    state = _rest_state(obs)
    jts, jdqds, _, _, accs, jc, _, _ = wbc.build_tasks(
        wbc.WbcConfig(), model, state, cmd)
    a_inv = torch.linalg.inv(fb.mass_matrix(model, state.q))
    eye = torch.eye(18)
    jc_masked = jc.reshape(1, 12, 18) * 0.0
    jc_bar = wbc._weighted_pinv(jc_masked, a_inv)
    qddot = torch.zeros(1, 18)
    n_pre = eye - jc_bar @ jc_masked
    for i in range(jts.shape[1]):
        jt_pre = jts[:, i] @ n_pre
        jt_bar = wbc._weighted_pinv(jt_pre, a_inv)
        qddot = qddot + (jt_bar @ (accs[:, i] - jdqds[:, i]
                                   - (jts[:, i] @ qddot[..., None])[..., 0]
                                   )[..., None])[..., 0]
        if i < jts.shape[1] - 1:
            n_pre = n_pre @ (eye - jt_bar @ jt_pre)
    realized = (jts[:, 1] @ qddot[..., None])[..., 0]
    np.testing.assert_allclose(realized.numpy(), accs[:, 1].numpy(),
                               atol=0.05)


def test_wbc_trot_through_rollout():
    """The JAX WBC trot check: `rollout` with use_wbc at vx = 0.25 and the
    robot's own body height stays up and tracks over 400 ticks."""
    params = a1_params("cpu")
    res = rollout_mod.rollout(
        _port_config(), params,
        TwistCommand.constant(vx=0.25, body_height=float(params.body_height),
                              device="cpu"), 400)
    assert float(res.alive[0]) == 1.0
    h = res.base_height_trace[0].numpy()
    assert np.all(np.isfinite(h)) and 0.2 < h[-1] < 0.35
    assert res.vel_trace[0, -100:, 0].mean().item() > 0.1


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    FIXTURE.parent.mkdir(exist_ok=True)
    arrays = dict(_fixture_view(_jax_run()), vx=np.asarray(VX, np.float32),
                  ticks=np.int32(TICKS), trace_stride=np.int32(TRACE_STRIDE))
    step, args = _jax_bench().build(B)
    for name, out in zip(("q_des", "dq_des", "tau"), step(*args)):
        arrays[f"wbc_tick_{name}"] = np.asarray(out)
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
