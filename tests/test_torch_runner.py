"""The port's robot runner (exec/runner.py) against the JAX package (CPU).

* The estimator path on the whole-body sim, resumed from checkpoints of a
  JAX run. The JAX package ran the full stack once at B=4 (forward speeds
  0.2 / 0.2 / 0.25 / 0.3 m/s, sensor noise levels 0 / 1 / 0 / 1 from a
  numpy seed, quadruped_tpu_torch/benchmarks/runner.py FIXTURE_*): the
  sitting boot, the FSM's 3 s STAND_UP ramp, LOCOMOTION from tick 1500,
  the estimated trot. tests/data/runner_a1.npz keeps its full state (sim,
  runner with estimators, the IMU's last velocity) at three checkpoints
  (tick 100 of the boot, tick 1400, 100 ticks before the switch, and tick
  2000 of the trot) and the traces of the window that follows each (150,
  200 and 120 ticks). The port resumes from each through
  `utils.convert.to_torch` with the same noise: the FSM states and the
  estimated contact flags must be equal tick for tick (so the switch lands
  on the same tick); the base position, the estimated position and
  velocity and the joint-angle commands may differ from JAX's by 10x
  JAX's own spread, with floors of 1e-5 m, 1e-4 m/s and 1e-3 rad
  (benchmarks/runner.py `window_errors`). JAX's spread is the most the
  window moves when JAX runs it again from a state one float32 step off in
  one coordinate (base height up and down, forward speed, a hip angle):
  the estimated trot is chaotic, two of those four runs flip a contact
  flag on tick 141 of the trot window (so it stops at 120) and move the
  base 1.3e-2 m within 150 ticks. CPU readings, port vs JAX (limit):
  boot position 2.5e-8 m (1e-5), estimated position 3.7e-8 m (1e-5),
  velocity estimate 1.0e-6 m/s (1e-4), joint commands 1.5e-8 rad (1e-3);
  switch 1.7e-4 (8.0e-3), 2.5e-4 (3.4e-2), 9.4e-3 (1.1), 1.2e-3 (0.24);
  trot 1.2e-2 (8.8e-2), 1.0e-2 (7.9e-2), 0.16 (1.5), 3.5e-2 (0.30).
* The ramp shortcut (`skip_idle_locomotion`, the default): the outputs are
  the same values with and without it over the window that crosses the
  switch, and without it every STAND_UP tick runs an MPC solve.
* The hold of the locomotion state outside LOCOMOTION: bit for bit.
* The ground-truth path on the SRB sim against `jax.vmap` of the JAX
  runner (the port of tests/test_runner.py: B=4, in LOCOMOTION, 300 ticks),
  and the RC channel: scripted joysticks through `rc_update` start the
  trot, raise the gait-switch pulse into the transition manager
  (`gait_b`), and stop, lower and sit two scenarios on different ticks;
  SIT_DOWN is entered on JAX's tick and the sit-down commands match.

Regenerate the fixture (only when the JAX reference changes on purpose;
a few minutes of JAX on the CPU):
    PYTHONPATH=. python tests/test_torch_runner.py
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from card_device import DEVICES, on
from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.control.fsm import FsmState
from quadruped_tpu_torch.utils.convert import as_numpy, flatten

torch.set_num_threads(1)

FIXTURE = bench_runner.FIXTURE
CHECKPOINTS = bench_runner.CHECKPOINTS
SEGMENT = 50          # ticks a compiled JAX segment scans
SWITCH_TICK = 1500    # the STAND_UP -> LOCOMOTION switch of the boot
# The one-float32-step nudges of JAX's spread: (FbState field, column,
# direction): base height up and down, forward speed, a hip angle.
NUDGES = (("position", 2, 1.0), ("position", 2, -1.0), ("vel_body", 0, 1.0),
          ("q", 1, 1.0))


def _jax_config():
    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.estimation.container import EstimatorConfig
    from quadruped_tpu.estimation.velocity import VelocityEstimatorConfig
    from quadruped_tpu.exec import RunnerConfig
    from quadruped_tpu.gait import ADVANCED_TROT

    return RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
            swing=swing.SwingConfig(), gait=ADVANCED_TROT()),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=True)


def _jax_fixture_runs():
    """The JAX run of the fixture: {checkpoint: (state, traces, spread)}."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.core import se3 as jse3
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.estimation.container import RawSensors
    from quadruped_tpu.exec import runner_init, runner_step
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import whole_body as jwb

    params = ja1()
    model = jfb.build_model(params)
    cm = jwb.ContactModel()
    config = _jax_config()
    sigma = jnp.asarray(bench_runner.NOISE_SIGMA, jnp.float32)
    dt = bench_runner.DT

    def boot(_):
        sim0 = jwb.whole_body_init(params, body_height=bench_runner.SIT_HEIGHT)
        sim0 = jwb.WholeBodySimState(
            fb=sim0.fb.replace(q=params.sitdown_angles), t=sim0.t)
        st0 = runner_init(config, params, jwb.observe(params, model, sim0, cm))
        return sim0, st0, jnp.zeros(3, jnp.float32)

    def segment(carry, vx, level, noise):
        cmd = JTC.constant(vx=vx, body_height=0.27)

        def step(carry, n):
            sim, st, prev_v = carry
            truth = jwb.observe(params, model, sim, cm)
            r = jse3.quat_to_rotmat(truth.base_quat)
            acc_world = (truth.base_vel_world - prev_v) / dt \
                + jnp.asarray([0.0, 0.0, 9.81])
            scaled = (level * sigma) * n
            sensors = RawSensors(
                quat=truth.base_quat,
                acc_body=acc_world @ r + scaled[0:3],
                omega_body=truth.base_omega_body + scaled[3:6],
                joint_angles=truth.joint_angles + scaled[6:18],
                joint_velocities=truth.joint_velocities + scaled[18:30],
                foot_forces=truth.foot_forces)
            command, _, st, est = runner_step(config, params, st, cmd,
                                              sensors=sensors)
            sim, _ = jwb.whole_body_step(params, model, sim, command, cm, dt)
            trace = {"position": sim.fb.position, "fsm": st.fsm.state,
                     "contact": st.estimator.contact.is_contact,
                     "v_est": est.base_vel_world,
                     "p_est": est.base_position, "q_cmd": command.q}
            return (sim, st, truth.base_vel_world), trace

        return jax.lax.scan(step, carry, noise)

    vx = jnp.asarray(bench_runner.FIXTURE_VX, jnp.float32)
    level = jnp.asarray(bench_runner.FIXTURE_NOISE, jnp.float32)
    noise = jnp.asarray(np.swapaxes(bench_runner.fixture_noise(), 0, 1))
    run_segment = jax.jit(jax.vmap(segment))
    carry = jax.jit(jax.vmap(boot))(jnp.arange(len(bench_runner.FIXTURE_VX)))

    def scan(carry, start, ticks):
        parts = []
        for k in range(start, start + ticks, SEGMENT):
            carry, tr = run_segment(carry, vx, level,
                                    noise[:, k:k + SEGMENT])
            parts.append(tr)
        return carry, {key: np.concatenate([np.asarray(p[key]) for p in parts],
                                           axis=1) for key in parts[0]}

    starts = {s: key for key, (s, _) in CHECKPOINTS.items()}
    saved, traces, tick = {}, [], 0
    while tick < bench_runner.FIXTURE_TICKS:
        if tick in starts:
            saved[starts[tick]] = carry
        carry, tr = scan(carry, tick, SEGMENT)
        traces.append(tr)
        tick += SEGMENT
    full = {key: np.concatenate([t[key] for t in traces], axis=1)
            for key in traces[0]}
    out = {}
    for key, (start, window) in CHECKPOINTS.items():
        sim, st, prev_v = saved[key]
        want = {k: v[:, start:start + window] for k, v in full.items()}
        # The window again from four nudged states, each one float32 step
        # off in one coordinate: JAX's own spread is the largest.
        spread = dict.fromkeys(bench_runner.FLOOR, 0.0)
        for field, col, way in NUDGES:
            leaf = getattr(sim.fb, field)
            moved = leaf.at[:, col].set(jnp.nextafter(leaf[:, col],
                                                      way * jnp.inf))
            nudged = sim.replace(fb=sim.fb.replace(**{field: moved}))
            _, again = scan((nudged, st, prev_v), start, window)
            for k in ("fsm", "contact"):
                assert np.array_equal(again[k], want[k]), (key, field, k)
            for k in spread:
                spread[k] = max(spread[k],
                                float(np.max(np.abs(again[k] - want[k]))))
        state = {"sim": as_numpy(sim), "runner": as_numpy(st),
                 "prev_v": np.asarray(prev_v)}
        out[key] = (state, want, spread)
    return out


def _regenerate():
    runs = _jax_fixture_runs()
    arrays = {"noise_head": bench_runner.fixture_noise()[:2]}
    for key, (state, traces, spread) in runs.items():
        arrays.update(flatten(state, f"{key}/state"))
        for k, v in traces.items():
            arrays[f"{key}/trace/{k}"] = (v.astype(np.int8)
                                          if k in ("fsm", "contact") else v)
        for k, v in spread.items():
            arrays[f"{key}/spread/{k}"] = np.float32(v)
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
    for key, (_, traces, spread) in runs.items():
        fsm = traces["fsm"]
        print(key, "fsm states", np.unique(fsm), "spread", spread)


@functools.lru_cache(maxsize=None)
def _port_windows(device="cpu"):
    data = np.load(FIXTURE)
    loop, rows, noise = bench_runner.window_loop(data, device=device)
    ticks = max(w for _, w in CHECKPOINTS.values())
    _, traces = bench_runner.run(loop, ticks, noise=noise, record=True)
    return traces, rows


def test_fixture_layout_and_noise_stream():
    """The fixture's checkpoints and windows, and the numpy noise stream
    the test regenerates is the one the JAX run drew."""
    data = np.load(FIXTURE)
    np.testing.assert_array_equal(data["noise_head"],
                                  bench_runner.fixture_noise()[:2])
    for key, (start, window) in CHECKPOINTS.items():
        assert data[f"{key}/trace/fsm"].shape == (4, window)
        assert data[f"{key}/trace/contact"].shape == (4, window, 4)
        np.testing.assert_allclose(data[f"{key}/state/runner/t"],
                                   start * bench_runner.DT, rtol=1e-4)
    fsm = data["switch/trace/fsm"]
    first = np.argmax(fsm == FsmState.LOCOMOTION, axis=1)
    np.testing.assert_array_equal(first + CHECKPOINTS["switch"][0],
                                  SWITCH_TICK - 1)
    assert (data["boot/trace/fsm"] == FsmState.STAND_UP).all()
    assert (data["trot/trace/fsm"] == FsmState.LOCOMOTION).all()


@pytest.mark.parametrize("device", DEVICES)
def test_windows_match_jax(device):
    """FSM states and contact flags equal on every tick of the three
    windows (the switch on the same tick), the rest within 10x JAX's
    spread, on the CPU and on the card."""
    traces, rows = _port_windows(on(device))
    errors = bench_runner.window_errors(np.load(FIXTURE), traces, rows)
    for key, errs in errors.items():
        for k, (err, limit) in errs.items():
            assert err <= limit, f"{key} {k}: {err} > {limit}"


def test_windows_are_alive_and_trot_on_estimates():
    """The windows hold what they are for: the ramp (heights rising), the
    switch, and an estimated trot whose velocity estimate stays within the
    JAX test's 0.15 m/s of the truth on average."""
    traces, rows = _port_windows()
    sw = traces["fsm"][rows["switch"]].numpy()
    assert (sw[:, 0] == FsmState.STAND_UP).all()
    assert (sw[:, -1] == FsmState.LOCOMOTION).all()
    trot = rows["trot"]
    h = traces["position"][trot][..., 2].numpy()
    assert (h > 0.2).all() and (h < 0.35).all()
    verr = (traces["v_est"][trot] - traces["v_true"][trot]).abs()
    assert float(verr.mean()) < 0.15
    swings = (traces["contact"][trot] == 0).sum().item()
    assert swings > 100


def _switch_loop(skip):
    data = np.load(FIXTURE)
    loop, _, noise = bench_runner.window_loop(
        data, ("switch",), "cpu",
        bench_runner.default_config("cpu", skip_idle_locomotion=skip))
    return loop, noise


def test_ramp_shortcut_keeps_the_outputs(monkeypatch):
    """With and without the shortcut, over 110 ticks from the pre-switch
    checkpoint (the switch on its 100th tick): the commands, forces,
    observations and states are equal on every tick; without it every
    tick runs the locomotion step, with it only the switch tick and the
    LOCOMOTION ticks after it."""
    from quadruped_tpu_torch.control import locomotion
    from quadruped_tpu_torch.exec import runner as runner_mod

    calls = []
    step = locomotion.locomotion_step
    monkeypatch.setattr(runner_mod, "locomotion_step",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    outs = {}
    for skip in (True, False):
        loop, noise = _switch_loop(skip)
        calls.clear()
        rows = []
        sim, st, prev_v = loop.sim, loop.runner, loop.prev_v
        for k in range(110):
            raw, truth = bench_runner.sensors(loop._replace(prev_v=prev_v),
                                              sim, noise[k])
            command, forces, st, obs = runner_mod.runner_step(
                loop.config, loop.params, st, loop.cmd, sensors=raw)
            sim, _ = bench_runner.wb.whole_body_step(
                loop.params, loop.model, sim, command, loop.contact,
                bench_runner.DT)
            prev_v = truth.base_vel_world
            rows.append(flatten({"command": as_numpy(command),
                                 "obs": as_numpy(obs),
                                 "state": as_numpy(st)}, "t"))
            rows[-1]["forces"] = forces.numpy()
        outs[skip] = (rows, len(calls), st.fsm.state.clone())
    (fast, n_fast, end), (full, n_full, _) = outs[True], outs[False]
    assert (end == FsmState.LOCOMOTION).all()
    switch = SWITCH_TICK - 1 - CHECKPOINTS["switch"][0]
    assert n_full == 110 and n_fast == 110 - switch, (n_full, n_fast)
    for k, (a, b) in enumerate(zip(fast, full)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"tick {k} {key}")


def test_locomotion_state_held_outside_locomotion():
    """Outside LOCOMOTION the runner returns the locomotion state it was
    given, bit for bit, whether or not the step ran (rows 0-3 in STAND_UP
    beside rows in LOCOMOTION)."""
    from quadruped_tpu_torch.exec import runner as runner_mod

    data = np.load(FIXTURE)
    loop, rows, noise = bench_runner.window_loop(data, ("boot", "trot"),
                                                 device="cpu")
    raw, _ = bench_runner.sensors(loop, loop.sim, noise[0])
    _, forces, st, _ = runner_mod.runner_step(loop.config, loop.params,
                                              loop.runner, loop.cmd,
                                              sensors=raw)
    before = flatten(as_numpy(loop.runner.locomotion), "l")
    after = flatten(as_numpy(st.locomotion), "l")
    held = rows["boot"]
    for key in before:
        np.testing.assert_array_equal(after[key][held], before[key][held],
                                      err_msg=key)
    assert (forces[held] == 0).all()
    moved = rows["trot"]
    assert not np.array_equal(after["l/gait/last_time"][moved],
                              before["l/gait/last_time"][moved])


# --- the ground-truth path on the SRB sim, and the RC channel ---------------

H = 0.27
GT_TICKS = 300
RC_TICKS = 300
# Per scenario: (tick of the X press that starts the trot, tick of the
# second X press (the gait switch) or None, tick of the B press that
# begins the body-down sequence (B, Rb, Rb on every 2nd tick) or None).
RC_SCRIPTS = [(0, None, None), (0, 60, None), (0, None, 150), (0, None, 220)]
# max |port - JAX| over the run (CPU reading, ground truth / RC): the MPC's
# 24 warm ADMM iterations carry float32 differences of the inputs into the
# forces at ~1e3x, so forces are held to 1% m*g.
GT_TOL = {"position": 1e-4,     # 1.1e-5 / 9.6e-6 m
          "vel_world": 1e-3,    # 8.4e-5 / 9.6e-5 m/s
          "q": 1e-3,            # 1.2e-4 / 5.8e-5 rad
          "forces": 1.28,       # 0.47 / 0.53 N
          "command_q": 5e-4}    # 6.8e-5 / 4.5e-5 rad


def _rc_stream():
    from quadruped_tpu_torch.control.rc_mode import BUTTONS

    b = len(RC_SCRIPTS)
    out = {k: np.zeros((RC_TICKS, b), np.float32)
           for k in ("vx", "vy", "wz") + BUTTONS}
    out["vx"][:] = 0.3
    for i, (start, switch, down) in enumerate(RC_SCRIPTS):
        out["btn_gait"][start, i] = 1.0
        if switch is not None:
            out["btn_gait"][switch, i] = 1.0
        if down is not None:
            for k, name in enumerate(("btn_stop", "btn_updown",
                                      "btn_updown")):
                out[name][down + 2 * k, i] = 1.0
    return out


def _gt_config(jax_side, rc):
    if jax_side:
        from quadruped_tpu.control import mpc, swing
        from quadruped_tpu.control.locomotion import LocomotionConfig
        from quadruped_tpu.exec import RunnerConfig
        from quadruped_tpu.gait import ADVANCED_TROT, TROT
        gait, gait_b = ADVANCED_TROT(), (TROT() if rc else None)
    else:
        from quadruped_tpu_torch.control import mpc, swing
        from quadruped_tpu_torch.control.locomotion import LocomotionConfig
        from quadruped_tpu_torch.exec import RunnerConfig
        from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
        gait, gait_b = ADVANCED_TROT("cpu"), (TROT("cpu") if rc else None)
    mpc_cfg = (mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120)
               if rc else mpc.MpcConfig(horizon=5, qp_iters=30))
    return RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc_cfg, swing=swing.SwingConfig(), gait=gait, gait_b=gait_b))


@functools.lru_cache(maxsize=None)
def _jax_srb(rc):
    """The JAX runner on the SRB sim, vmapped over 4 scenarios from their
    stand in LOCOMOTION: constant vx = 0.2 (the configuration of
    tests/test_runner.py), or through rc_update on the scripted joysticks
    (with TROT as gait_b)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import rc_mode as jrc
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.fsm import FsmState as JF
    from quadruped_tpu.exec import runner_init, runner_step
    from quadruped_tpu.gait.scheduler import stance_contact_mask
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import srb_sim

    params = ja1()
    config = _gt_config(True, rc)
    stream = {k: jnp.asarray(v) for k, v in _rc_stream().items()}

    def robot(joys):
        sim0 = srb_sim.srb_sim_init(params)
        st0 = runner_init(config, params,
                          srb_sim.observe(params, sim0, jnp.ones(4)))
        st0 = st0.replace(fsm=st0.fsm.replace(
            state=jnp.asarray(JF.LOCOMOTION, jnp.int32)))

        def step(carry, joy):
            sim, st, rc_state = carry
            if rc:
                rc_state, cmd, req, _ = jrc.rc_update(rc_state, joy, H)
            else:
                cmd, req = JTC.constant(vx=0.2, body_height=H), None
            obs = srb_sim.observe(params, sim,
                                  stance_contact_mask(st.locomotion.gait))
            command, forces, st, _ = runner_step(config, params, st, cmd,
                                                 observation=obs,
                                                 fsm_request=req)
            in_loco = st.fsm.state == JF.LOCOMOTION
            stance = stance_contact_mask(st.locomotion.gait)
            sim = srb_sim.srb_sim_step(
                params, sim, forces, jnp.where(in_loco, stance, jnp.ones(4)),
                command.q, command.dq,
                jnp.where(in_loco, 1.0 - jnp.repeat(stance, 3),
                          jnp.zeros(12)), 0.002)
            trans = (st.locomotion.transition.phase if rc
                     else jnp.zeros((), jnp.int32))
            return (sim, st, rc_state), {
                "position": sim.position, "vel_world": sim.vel_world,
                "q": sim.q, "forces": forces, "command_q": command.q,
                "fsm": st.fsm.state, "transition": trans}

        return jax.lax.scan(step, (sim0, st0, jrc.rc_init()), joys)[1]

    ticks = RC_TICKS if rc else GT_TICKS
    joys = jrc.JoyInput(**{k: v[:ticks] for k, v in stream.items()})
    out = jax.jit(jax.vmap(robot, in_axes=1))(joys)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_srb(rc):
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.rc_mode import (JoyInput, rc_init,
                                                     rc_update)
    from quadruped_tpu_torch.robots import a1_params

    b = len(RC_SCRIPTS)
    params = a1_params("cpu")
    config = _gt_config(False, rc)
    sim, st = bench_runner.srb_boot(config, params, b)
    rc_state = rc_init(b, device="cpu")
    stream = _rc_stream()
    cmd = TwistCommand.constant(vx=0.2, body_height=H, batch=b, device="cpu")
    rows = {k: [] for k in ("position", "vel_world", "q", "forces",
                            "command_q", "fsm", "transition")}
    for k in range(RC_TICKS if rc else GT_TICKS):
        req = None
        if rc:
            joy = JoyInput(**{n: torch.as_tensor(v[k])
                              for n, v in stream.items()})
            rc_state, cmd, req, _ = rc_update(rc_state, joy, H)
        sim, st, command, forces = bench_runner.srb_tick(
            config, params, sim, st, cmd, fsm_request=req)
        for key, v in (("position", sim.position),
                       ("vel_world", sim.vel_world), ("q", sim.q),
                       ("forces", forces), ("command_q", command.q),
                       ("fsm", st.fsm.state),
                       ("transition", st.locomotion.transition.phase
                        if rc else torch.zeros(b, dtype=torch.int32))):
            rows[key].append(v.clone())
    return {k: torch.stack(v, 1).numpy() for k, v in rows.items()}


@pytest.mark.parametrize("rc", [False, True], ids=["ground_truth", "rc"])
def test_srb_runner_matches_jax(rc):
    """The ground-truth path (and the RC channel) on the SRB sim: FSM
    states and transition phases equal tick for tick, the sim state,
    forces and commands within GT_TOL."""
    want, got = _jax_srb(rc), _port_srb(rc)
    np.testing.assert_array_equal(got["fsm"], want["fsm"])
    np.testing.assert_array_equal(got["transition"], want["transition"])
    live = got["fsm"] == FsmState.LOCOMOTION
    for k, tol in GT_TOL.items():
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= tol, (k, err)
    if not rc:
        assert live.all()
        h = got["position"][:, -1, 2]
        assert ((0.2 < h) & (h < 0.35)).all()
        assert (got["position"][:, -1, 0] > 0.02).all()


def test_rc_enters_sit_down_on_the_scripted_ticks():
    """The RC channel through runner_step: SIT_DOWN entered on the tick of
    the second Rb press (the BODY_DOWN request) of scenarios 2 and 3 and
    never in 0 and 1; the gait-switch pulse of scenario 1 starts its
    transition on its X press."""
    got = _port_srb(True)
    for i, (_, switch, down) in enumerate(RC_SCRIPTS):
        fsm = got["fsm"][i]
        if down is None:
            assert (fsm == FsmState.LOCOMOTION).all(), i
        else:
            first = int(np.argmax(fsm == FsmState.SIT_DOWN))
            assert first == down + 4, (i, first)
            assert (fsm[first:] == FsmState.SIT_DOWN).all()
        trans = got["transition"][i]
        if switch is None:
            assert (trans == 0).all(), i
        else:
            assert (trans[:switch] == 0).all() and trans[switch] != 0, i


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    _regenerate()
