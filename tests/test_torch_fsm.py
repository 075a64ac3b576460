"""The port's control FSM, safety checks, actions, RC mode machine and
teleop against the JAX package (CPU), and the JAX package's own checks of
them (tests/test_fsm.py, tests/test_rc_mode.py:27-99,
tests/test_zmp_teleop.py) on the port.

The JAX functions run under `jax.jit` of `jax.vmap`. States, modes,
requests and pulses must be equal; joint commands are held to CMD_TOL
(measured 2.4e-7, two float32 steps of the smoothstep blend, whose
division by the 3 s duration both compute as a product with the float32
reciprocal, as XLA compiles it). The stand-up and sit-down blends are
driven by `fsm_step` alone, with t the running float32 sum of the 2 ms control
period as the runner forms it, so the tick on which the 3 s ramp
completes is decided by the same float32 additions in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import fsm as jfsm
from quadruped_tpu.control import rc_mode as jrc
from quadruped_tpu.control import safety as jsafety
from quadruped_tpu.control.types import HybridCommand as JHC
from quadruped_tpu.control.types import RobotObservation as JObs
from quadruped_tpu.robots import a1_params as ja1
from quadruped_tpu_torch.control import actions, fsm, safety
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.fsm import FsmMode, FsmState
from quadruped_tpu_torch.control.rc_mode import (JoyInput, RcMode, rc_init,
                                                 rc_update)
from quadruped_tpu_torch.control.teleop import (apply_key, joy_from_key,
                                                step_trace)
from quadruped_tpu_torch.control.types import HybridCommand, RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.estimation.zmp import compute_zmp, support_margin
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.utils.convert import as_numpy, to_torch

torch.set_num_threads(1)

CMD_TOL = 1e-6
DT = 0.002
H = 0.27


def tt(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _obs_arrays(rpy, height, q):
    """Observation leaves as numpy, [B, ...]."""
    rpy = np.asarray(rpy, np.float32)
    b = rpy.shape[0]
    return dict(base_position=np.stack([np.zeros(b), np.zeros(b), height],
                                       -1).astype(np.float32),
                base_rpy=rpy,
                base_quat=se3.rpy_to_quat(tt(rpy)).numpy(),
                base_vel_world=np.zeros((b, 3), np.float32),
                base_omega_world=np.zeros((b, 3), np.float32),
                base_omega_body=np.zeros((b, 3), np.float32),
                joint_angles=np.asarray(q, np.float32),
                joint_velocities=np.zeros((b, 12), np.float32),
                foot_contact=np.ones((b, 4), np.float32),
                foot_forces=np.full((b, 4), 30.0, np.float32))


def _loco_arrays(b, rng):
    return {k: rng.normal(0.0, s, (b, 12)).astype(np.float32)
            for k, s in (("q", 0.5), ("kp", 20.0), ("dq", 1.0), ("kd", 2.0),
                         ("tau", 30.0))}


def _jax_fsm_step(fsm_state, obs, t, loco, request):
    params = ja1()
    return jax.jit(jax.vmap(lambda f, o, t, c, r: jfsm.fsm_step(
        params, f, o, t, c, desired_state=r)))(fsm_state, obs, t, loco,
                                               request)


def _assert_command(got: HybridCommand, want):
    for f in ("q", "kp", "dq", "kd", "tau"):
        err = np.max(np.abs(getattr(got, f).numpy()
                            - np.asarray(getattr(want, f))))
        assert err <= CMD_TOL, (f, err)


def test_fsm_step_mixed_batch_matches_jax():
    """All four states, requests for every state, ESTOP by roll, pitch and
    (in LOCOMOTION only) height, ramps mid-way and complete, in one batch
    of 32: commands, next states, modes, entry times and poses as JAX."""
    rng = np.random.default_rng(0)
    b = 32
    params = a1_params("cpu")
    state = np.arange(b) % 4
    request = rng.integers(0, 4, b)
    rpy = rng.normal(0.0, 0.05, (b, 3))
    rpy[5::8, 0] = 0.7              # rolled over
    rpy[6::8, 1] = -0.6             # pitched over
    height = rng.uniform(0.1, 0.35, b)
    height[2::8] = 0.05             # below the envelope (LOCOMOTION)
    height[3::8] = 0.05             # below the envelope (SIT_DOWN: fine)
    q = np.asarray(params.sitdown_angles) + rng.normal(0.0, 0.1, (b, 12))
    start = rng.uniform(0.0, 2.0, b).astype(np.float32)
    t = (start + rng.uniform(0.0, 4.0, b)).astype(np.float32)
    q_entry = (np.asarray(params.stand_angles)
               + rng.normal(0.0, 0.2, (b, 12))).astype(np.float32)
    obs = _obs_arrays(rpy, height, q)
    loco = _loco_arrays(b, rng)

    jstate = jfsm.ControlFsmState(
        state=jnp.asarray(state, jnp.int32),
        mode=jnp.zeros(b, jnp.int32), state_start_time=jnp.asarray(start),
        q_at_entry=jnp.asarray(q_entry),
        desired_state=jnp.full(b, FsmState.LOCOMOTION, jnp.int32))
    jcmd, jnew, jin = _jax_fsm_step(
        jstate, JObs(**obs), t, JHC(**loco), jnp.asarray(request, jnp.int32))

    tstate = to_torch(jstate, fsm.ControlFsmState, device="cpu")
    cmd, new, in_loco = fsm.fsm_step(
        params, tstate, RobotObservation(**{k: tt(v) for k, v in obs.items()}),
        tt(t), HybridCommand(**{k: tt(v) for k, v in loco.items()}),
        desired_state=tt(request, torch.int32))
    _assert_command(cmd, jcmd)
    for f, v in as_numpy(jnew).items():
        np.testing.assert_array_equal(getattr(new, f).numpy(), v,
                                      err_msg=f)
    np.testing.assert_array_equal(in_loco.numpy(), np.asarray(jin))
    # The batch covers what it is meant to.
    assert set(new.state.tolist()) == {0, 1, 2, 3}
    assert (new.mode == FsmMode.ESTOP).sum() >= 8
    assert (new.state != tstate.state).sum() >= 8


@pytest.mark.parametrize("start_state,ticks", [
    (FsmState.STAND_UP, 1600), (FsmState.SIT_DOWN, 1600)])
def test_blend_completes_on_jax_tick(start_state, ticks):
    """The 3 s stand-up (into LOCOMOTION) and sit-down (into PASSIVE)
    ramps driven by fsm_step alone, t the running float32 sum of 2 ms:
    the state sequence equals JAX's tick for tick, the switch lands on the
    same tick (1500 additions of 0.002 in float32 decide it), and the blend
    commands are JAX's."""
    b = 4
    params = a1_params("cpu")
    q0 = np.tile(np.asarray(params.sitdown_angles if start_state ==
                            FsmState.STAND_UP else params.stand_angles),
                 (b, 1)).astype(np.float32)
    obs = _obs_arrays(np.zeros((b, 3)), np.full(b, 0.27), q0)
    loco = _loco_arrays(b, np.random.default_rng(1))
    request = np.full(b, FsmState.LOCOMOTION, np.int32)
    if start_state == FsmState.SIT_DOWN:
        request[:] = FsmState.SIT_DOWN

    def scan(f0, obs, loco, request):
        def step(carry, _):
            f, t = carry
            t = t + DT
            cmd, f, _ = jax.vmap(lambda f, o, t, c, r: jfsm.fsm_step(
                ja1(), f, o, t, c, desired_state=r))(f, obs, t, loco, request)
            return (f, t), (f.state, cmd.q)
        return jax.lax.scan(step, (f0, jnp.zeros(b, jnp.float32)), None,
                            length=ticks)[1]

    jf0 = jax.vmap(jfsm.fsm_init)(jnp.asarray(q0))
    jf0 = jf0.replace(state=jnp.full(b, start_state, jnp.int32))
    jstates, jq = jax.jit(scan)(jf0, JObs(**obs), JHC(**loco),
                                jnp.asarray(request))
    jstates, jq = np.asarray(jstates), np.asarray(jq)

    tobs = RobotObservation(**{k: tt(v) for k, v in obs.items()})
    tloco = HybridCommand(**{k: tt(v) for k, v in loco.items()})
    f = fsm.fsm_init(tt(q0))
    f.state[:] = start_state
    t = torch.zeros(b)
    states, qs = [], []
    for _ in range(ticks):
        t = t + DT
        cmd, f, _ = fsm.fsm_step(params, f, tobs, t, tloco,
                                 desired_state=tt(request, torch.int32))
        states.append(f.state.clone())
        qs.append(cmd.q)
    states = torch.stack(states).numpy()
    np.testing.assert_array_equal(states, jstates)
    assert np.max(np.abs(torch.stack(qs).numpy() - jq)) <= CMD_TOL
    switch = int(np.argmax(states[:, 0] != start_state))
    assert 1490 < switch < 1510, switch
    done = FsmState.LOCOMOTION if start_state == FsmState.STAND_UP \
        else FsmState.PASSIVE
    assert (states[switch:] == done).all()
    # The blend reached its target pose before the switch.
    target = (params.standup_angles if start_state == FsmState.STAND_UP
              else params.sitdown_angles).numpy()
    np.testing.assert_allclose(qs[switch - 1].numpy(),
                               np.tile(target, (b, 1)), atol=1e-5)


def _make_obs(params, rpy=(0.0, 0.0, 0.0), height=0.28):
    return RobotObservation(**{k: tt(v) for k, v in _obs_arrays(
        [rpy], [height], params.sitdown_angles[None].numpy()).items()})


def _loco_cmd():
    z = torch.zeros(1, 12)
    return HybridCommand(q=z, kp=z, dq=z, kd=z, tau=z + 1.0)


def test_standup_then_locomotion():
    """The port of test_fsm.py::test_standup_then_locomotion."""
    params = a1_params("cpu")
    obs = _make_obs(params)
    state = fsm.fsm_init(params.sitdown_angles[None].clone())
    assert int(state.state) == FsmState.STAND_UP
    cmd, state, in_loco = fsm.fsm_step(params, state, obs, tt([1.5]),
                                       _loco_cmd())
    assert float(in_loco) == 0.0
    q = cmd.q[0].numpy()
    lo = np.minimum(params.sitdown_angles.numpy(),
                    params.standup_angles.numpy()) - 1e-4
    hi = np.maximum(params.sitdown_angles.numpy(),
                    params.standup_angles.numpy()) + 1e-4
    assert np.all((q >= lo) & (q <= hi))
    cmd, state, in_loco = fsm.fsm_step(params, state, obs, tt([3.5]),
                                       _loco_cmd())
    assert int(state.state) == FsmState.LOCOMOTION
    cmd, state, in_loco = fsm.fsm_step(params, state, obs, tt([3.6]),
                                       _loco_cmd())
    assert float(in_loco) == 1.0
    np.testing.assert_allclose(cmd.tau.numpy(), 1.0)


def test_estop_on_bad_orientation():
    """The port of test_fsm.py::test_estop_on_bad_orientation."""
    params = a1_params("cpu")
    state = fsm.fsm_init(params.stand_angles[None].clone())
    state.state[:] = FsmState.LOCOMOTION
    obs = _make_obs(params, rpy=(0.7, 0.0, 0.0))
    cmd, state, _ = fsm.fsm_step(params, state, obs, tt([5.0]), _loco_cmd())
    assert int(state.mode) == FsmMode.ESTOP
    assert int(state.state) == FsmState.PASSIVE
    np.testing.assert_allclose(cmd.tau.numpy(), 0.0)
    np.testing.assert_allclose(cmd.kp.numpy(), 0.0)
    assert np.all(cmd.kd.numpy() > 0)


def test_torque_clip_and_safe_command_match_jax():
    """The port of test_fsm.py::test_torque_clip, and `safe_command` on a
    batch with unsafe orientations and heights against JAX."""
    params = a1_params("cpu")
    big = HybridCommand(q=torch.zeros(1, 12), kp=torch.zeros(1, 12),
                        dq=torch.zeros(1, 12), kd=torch.zeros(1, 12),
                        tau=torch.full((1, 12), 100.0))
    clipped, safe = safety.safe_command(params, _make_obs(params), big)
    assert float(safe) == 1.0
    np.testing.assert_allclose(clipped.tau.numpy(),
                               float(params.torque_limit))
    rng = np.random.default_rng(2)
    b = 16
    rpy = rng.normal(0.0, 0.4, (b, 3))
    height = rng.uniform(0.0, 0.5, b)
    height[0] = np.nan
    obs = _obs_arrays(rpy, height, np.zeros((b, 12)))
    loco = _loco_arrays(b, rng)
    jc, js = jax.jit(jax.vmap(lambda o, c: jsafety.safe_command(
        ja1(), o, c)))(JObs(**obs), JHC(**loco))
    gc, gs = safety.safe_command(
        params, RobotObservation(**{k: tt(v) for k, v in obs.items()}),
        HybridCommand(**{k: tt(v) for k, v in loco.items()}))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
    _assert_command(gc, jc)
    assert 0 < gs.sum() < b


def test_actions_match_jax():
    """The blends mid-ramp, keep-stand and foot control against JAX."""
    from quadruped_tpu.control import actions as jact

    params = a1_params("cpu")
    rng = np.random.default_rng(3)
    b = 8
    q0 = (np.asarray(params.stand_angles)
          + rng.normal(0.0, 0.2, (b, 12))).astype(np.float32)
    t = rng.uniform(-0.5, 3.5, b).astype(np.float32)
    for jfn, fn in ((jact.standup_command, actions.standup_command),
                    (jact.sitdown_command, actions.sitdown_command)):
        want = jax.jit(jax.vmap(lambda q, t, f=jfn: f(ja1(), q, t)))(q0, t)
        _assert_command(fn(params, tt(q0), tt(t)), want)
    stand = actions.keep_stand_command(params, b)
    _assert_command(stand, jax.vmap(lambda _: jact.keep_stand_command(
        ja1()))(jnp.arange(b)))
    feet = (np.asarray(params.default_hip_position)
            + [0.0, 0.0, -0.25] + rng.normal(0.0, 0.02, (b, 4, 3))
            ).astype(np.float32)
    want = jax.jit(jax.vmap(lambda f: jact.control_foot_command(ja1(), f)))(
        feet)
    got = actions.control_foot_command(params, tt(feet))
    assert np.max(np.abs(got.q.numpy() - np.asarray(want.q))) <= 1e-5


# --- the RC mode machine -----------------------------------------------------

# Scripted joystick sequences (one per scenario of the batch): a list of
# (button or None, vx) per tick; a button is held for one tick and
# released on the next.
SCRIPTS = [
    [("btn_gait", 0.4), (None, 0.4), ("btn_gait", 0.4), (None, 0.4),
     ("btn_gait", 0.0), (None, 0.0), ("btn_stop", 0.4), (None, 0.4)],
    [("btn_updown", 0.0), (None, 0.0), ("btn_updown", 0.0), (None, 0.0),
     ("btn_exit", 0.0), (None, 0.0), ("btn_stop", 0.0), (None, 0.0),
     ("btn_updown", 0.0), (None, 0.0), ("btn_stop", 0.0), (None, 0.0)],
    [("btn_updown", 0.0), (None, 0.0), ("btn_exit", 0.0), (None, 0.0)],
    [("btn_gait", -0.3), (None, -0.3)],
    [("btn_gait", 0.4), (None, 0.4), ("btn_joy", 0.4), (None, 0.4),
     ("btn_joy", 0.4), (None, 0.4)],
]


def _joy_stream():
    """[T] JoyInput arrays, [T, B] each, from SCRIPTS (padded neutral)."""
    ticks = max(len(s) for s in SCRIPTS)
    b = len(SCRIPTS)
    out = {k: np.zeros((ticks, b), np.float32)
           for k in ("vx", "vy", "wz", "btn_joy", "btn_gait", "btn_stop",
                     "btn_exit", "btn_updown")}
    for i, script in enumerate(SCRIPTS):
        for k, (button, vx) in enumerate(script):
            out["vx"][k, i] = vx
            if button:
                out[button][k, i] = 1.0
    return out


def _port_rc_run(stream):
    ticks, b = stream["vx"].shape
    st = rc_init(b, device="cpu")
    rows = []
    for k in range(ticks):
        joy = JoyInput(**{n: tt(v[k]) for n, v in stream.items()})
        st, cmd, req, pulse = rc_update(st, joy, H)
        rows.append((st, cmd, req, pulse))
    return rows


def test_rc_update_matches_jax_over_scripts():
    """Every tick of the scripted sequences (the button presses of
    tests/test_rc_mode.py:27-99, one script a scenario): the RC state,
    command, FSM request and pulse equal JAX's."""
    stream = _joy_stream()
    b = stream["vx"].shape[1]

    def scan(stream):
        def step(st, joy):
            out = jax.vmap(lambda s, j: jrc.rc_update(s, j, H))(st, joy)
            return out[0], out
        st0 = jax.vmap(lambda _: jrc.rc_init())(jnp.arange(b))
        return jax.lax.scan(step, st0, jrc.JoyInput(**stream))[1]

    jst, jcmd, jreq, jpulse = jax.jit(scan)(
        {k: jnp.asarray(v) for k, v in stream.items()})
    for k, (st, cmd, req, pulse) in enumerate(_port_rc_run(stream)):
        for f, v in as_numpy(jax.tree.map(lambda a: a[k], jst)).items():
            np.testing.assert_array_equal(getattr(st, f).numpy(), v,
                                          err_msg=f"{f} tick {k}")
        for f in ("linear", "angular_z", "body_height", "gait_switch"):
            np.testing.assert_array_equal(getattr(cmd, f).numpy(),
                                          np.asarray(getattr(jcmd, f)[k]),
                                          err_msg=f"{f} tick {k}")
        np.testing.assert_array_equal(req.numpy(), np.asarray(jreq[k]))
        np.testing.assert_array_equal(pulse.numpy(), np.asarray(jpulse[k]))
    carried = to_torch(jax.tree.map(lambda a: a[-1], jst),
                       type(st), device="cpu")
    assert torch.equal(carried.prev_buttons, st.prev_buttons)


def _press(state, **kw):
    out = rc_update(state, JoyInput.neutral(device="cpu", **kw), H)
    st2, *_ = rc_update(out[0], JoyInput.neutral(
        vx=kw.get("vx", 0.0), vy=kw.get("vy", 0.0), wz=kw.get("wz", 0.0),
        device="cpu"), H)
    return (st2,) + out[1:]


def test_mode_cycle_and_commands():
    """The port of test_rc_mode.py::test_mode_cycle_and_commands."""
    st = rc_init(1, device="cpu")
    assert int(st.mode) == RcMode.JOY_STAND
    st, cmd, req, pulse = _press(st, btn_gait=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT
    assert int(req) == FsmState.LOCOMOTION
    np.testing.assert_allclose(float(cmd.linear[0, 0]), 0.4)
    st, cmd, req, pulse = _press(st, btn_gait=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_TROT
    assert float(pulse) == 1.0
    assert int(req) == FsmState.LOCOMOTION
    st, cmd, req, pulse = _press(st, btn_gait=1.0)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT
    st, cmd, req, pulse = _press(st, btn_stop=1.0, vx=0.4)
    assert int(st.mode) == RcMode.JOY_STAND
    assert float(cmd.linear[0, 0]) == 0.0
    assert int(req) == FsmState.LOCOMOTION
    assert float(pulse) == 0.0


def test_body_up_down_exit():
    """The port of test_rc_mode.py::test_body_up_down_exit."""
    st = rc_init(1, device="cpu")
    st, cmd, req, _ = _press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_UP and int(req) == FsmState.STAND_UP
    st, cmd, req, _ = _press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_DOWN and int(req) == FsmState.SIT_DOWN
    st, cmd, req, _ = _press(st, btn_exit=1.0)
    assert int(st.mode) == RcMode.EXIT and int(req) == FsmState.PASSIVE
    st, cmd, req, _ = _press(st, btn_stop=1.0)
    assert int(st.mode) == RcMode.EXIT
    st, cmd, req, _ = _press(st, btn_updown=1.0)
    assert int(st.mode) == RcMode.BODY_UP and int(req) == FsmState.STAND_UP
    st, cmd, req, _ = _press(st, btn_stop=1.0)
    assert int(st.mode) == RcMode.JOY_STAND
    assert int(st.body_up) == 0


def test_exit_blocked_while_up():
    """The port of test_rc_mode.py::test_exit_blocked_while_up."""
    st = rc_init(1, device="cpu")
    st, *_ = _press(st, btn_updown=1.0)
    st, cmd, req, _ = _press(st, btn_exit=1.0)
    assert int(st.mode) == RcMode.BODY_UP
    assert int(req) == FsmState.STAND_UP


def test_backward_walk_height_compensation():
    """The port of test_rc_mode.py::test_backward_walk_height_compensation."""
    st, cmd, *_ = _press(rc_init(1, device="cpu"), btn_gait=1.0, vx=-0.3)
    np.testing.assert_allclose(float(cmd.body_height), H * 0.85, rtol=1e-6)


def test_joy_toggle_gates_sticks():
    """The port of test_rc_mode.py::test_joy_toggle_gates_sticks."""
    st, cmd, *_ = _press(rc_init(1, device="cpu"), btn_gait=1.0, vx=0.4)
    np.testing.assert_allclose(float(cmd.linear[0, 0]), 0.4, rtol=1e-6)
    st, cmd, *_ = _press(st, btn_joy=1.0, vx=0.4)
    assert float(cmd.linear[0, 0]) == 0.0


# --- ZMP and teleop (tests/test_zmp_teleop.py on the port) ------------------

def test_zmp_static_equals_com():
    np.testing.assert_allclose(
        compute_zmp(tt([0.1, 0.05, 0.28]), torch.zeros(3)).numpy(),
        [0.1, 0.05], atol=1e-6)


def test_zmp_accel_shifts_backward():
    assert float(compute_zmp(tt([0.0, 0.0, 0.28]), tt([1.0, 0.0, 0.0]))[0]) < 0


def test_support_margin_sign():
    feet = tt([[0.17, -0.13, 0], [0.17, 0.13, 0], [-0.17, -0.13, 0],
               [-0.17, 0.13, 0]])
    assert float(support_margin(tt([0.0, 0.0]), feet, torch.ones(4))) > 0
    assert float(support_margin(tt([0.5, 0.0]), feet, torch.ones(4))) < 0
    contact = tt([0.0, 1.0, 1.0, 1.0])
    m_front = support_margin(tt([0.15, -0.1]), feet, contact)
    m_back = support_margin(tt([-0.05, 0.05]), feet, contact)
    assert float(m_back) > float(m_front)


def test_step_trace_and_keys():
    tr = step_trace(10, [(0, 0.0), (5, 0.4)], device="cpu")
    assert tr.linear.shape == (10, 3)
    np.testing.assert_allclose(float(tr.linear[7, 0]), 0.4, atol=1e-6)
    np.testing.assert_allclose(float(tr.linear[3, 0]), 0.0, atol=1e-6)
    c = apply_key(TwistCommand.constant(device="cpu"), "w")
    np.testing.assert_allclose(float(c.linear[0, 0]), 0.1, atol=1e-6)
    c = apply_key(c, "q")
    np.testing.assert_allclose(float(c.angular_z[0]), 0.2, atol=1e-6)
    c = apply_key(c, " ")
    np.testing.assert_allclose(c.linear.numpy(), 0.0, atol=1e-6)


def test_keyboard_to_rc_joy():
    st = rc_init(1, device="cpu")
    sticks = (0.0, 0.0, 0.0)
    joy, sticks = joy_from_key("k", sticks, device="cpu")
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    assert int(st.mode) == RcMode.JOY_ADVANCED_TROT
    joy, sticks = joy_from_key("w", sticks, device="cpu")
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    np.testing.assert_allclose(float(cmd.linear[0, 0]), 0.1, rtol=1e-5)
    joy, sticks = joy_from_key("l", sticks, device="cpu")
    st, cmd, req, _ = rc_update(st, joy, 0.27)
    assert int(st.mode) == RcMode.JOY_STAND
    assert float(cmd.linear[0, 0]) == 0.0
