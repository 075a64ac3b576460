"""Module-by-module parity of the port against the JAX package.

One parametrised test, one case per ported function. Inputs come from
numpy (`np.random.default_rng`) or, for the controller and simulator
steps, from a short JAX closed-loop rollout whose carry is converted to the
port (utils/convert.py), so both sides step from the same state. JAX
functions are `jax.vmap`-ed over the scenario axis.

Tolerance: float32, ~1e-5 relative (`rtol=1e-5`, `atol=1e-5` on O(1)
values) unless a case states a looser bound and why.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import desired_state as j_des
from quadruped_tpu.control import mpc as j_mpc
from quadruped_tpu.control import swing as j_swing
from quadruped_tpu.control.desired_state import TwistCommand as JTC
from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
from quadruped_tpu.core import linalg as j_linalg
from quadruped_tpu.core import se3 as j_se3
from quadruped_tpu.core import splines as j_splines
from quadruped_tpu.dynamics import srb as j_srb
from quadruped_tpu.gait import ADVANCED_TROT as JAT
from quadruped_tpu.gait import scheduler as j_sched
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.robots import kinematics as j_kin
from quadruped_tpu.sim import rollout as j_rollout
from quadruped_tpu.sim import srb_sim as j_sim
from quadruped_tpu.solvers import condense as j_condense
from quadruped_tpu_torch.control import desired_state as t_des
from quadruped_tpu_torch.control import mpc as t_mpc
from quadruped_tpu_torch.control import swing as t_swing
from quadruped_tpu_torch.control.locomotion import LocomotionState
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg as t_linalg
from quadruped_tpu_torch.core import se3 as t_se3
from quadruped_tpu_torch.core import splines as t_splines
from quadruped_tpu_torch.dynamics import srb as t_srb
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait import scheduler as t_sched
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots import kinematics as t_kin
from quadruped_tpu_torch.sim import srb_sim as t_sim
from quadruped_tpu_torch.solvers import condense as t_condense
from quadruped_tpu_torch.utils.convert import as_numpy, to_torch

B = 4
H = 5
MG = 13.0 * 9.81


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _joints(rng, n):
    base = np.tile(np.array([0.0, 0.67, -1.25], np.float32), 4)
    return (base + rng.normal(size=(n, 12)) * 0.15).astype(np.float32)


# --- core ------------------------------------------------------------------

def case_se3():
    rng = _rng(1)
    rpy = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    q = _quats(rng, B)
    v = rng.normal(size=(B, 3)).astype(np.float32)
    m = rng.normal(size=(B, 3, 3)).astype(np.float32) + 3 * np.eye(3)
    ang = rng.uniform(-10, 10, B).astype(np.float32)
    pairs = [
        (t_se3.rpy_to_rotmat(tt(rpy)), j_se3.rpy_to_rotmat(rpy)),
        (t_se3.rot_z(tt(ang)), j_se3.rot_z(ang)),
        (t_se3.rot_x(tt(ang)), j_se3.rot_x(ang)),
        (t_se3.quat_to_rotmat(tt(q)), j_se3.quat_to_rotmat(q)),
        (t_se3.quat_to_rpy(tt(q)), j_se3.quat_to_rpy(q)),
        (t_se3.quat_integrate(tt(q), tt(v), 0.002),
         j_se3.quat_integrate(q, v, 0.002)),
        (t_se3.skew(tt(v)), j_se3.skew(v)),
        (t_se3.inv3x3(tt(m)), j_se3.inv3x3(m)),
        (t_se3.matmul3(tt(m), tt(m)), j_se3.matmul3(m, m)),
        (t_se3.wrap_angle(tt(ang)), j_se3.wrap_angle(ang)),
    ]
    return pairs, {}


def case_linalg_inv_spd():
    rng = _rng(2)
    out = []
    for n in (3, 6):
        a = rng.normal(size=(B, n, n)).astype(np.float32)
        m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)
        out.append((t_linalg.inv_spd(tt(m)), j_linalg.inv_spd(m)))
    # inv of kappa ~ 1e2 SPD matrices: f32 roundoff of the Schur recursion.
    return out, dict(rtol=1e-4, atol=1e-4)


def case_splines():
    rng = _rng(3)
    s = rng.normal(size=(B, 4, 3)).astype(np.float32)
    e = rng.normal(size=(B, 4, 3)).astype(np.float32)
    phi = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    out = []
    for tf, jf in [(t_splines.swing_parabola, j_splines.swing_parabola),
                   (t_splines.swing_cubic, j_splines.swing_cubic),
                   (t_splines.swing_bspline, j_splines.swing_bspline)]:
        out += list(zip(tf(tt(s), tt(e), 0.1, tt(phi)),
                        jf(s, e, 0.1, phi)))
    # B-spline velocity is a 1e-3 finite difference: f32 cancellation
    # scales roundoff by 1e3.
    return out, dict(rtol=1e-4, atol=2e-3)


# --- robots / dynamics / condensation --------------------------------------

def case_kinematics():
    rng = _rng(4)
    tp, jp = a1_params("cpu"), j_a1()
    q = _joints(rng, B)
    f = rng.normal(size=(B, 4, 3)).astype(np.float32) * 30
    v = rng.normal(size=(B, 4, 3)).astype(np.float32)
    feet = np.asarray(jax.vmap(
        lambda a: j_kin.foot_positions_in_base_frame(jp, a))(q))
    jac = np.asarray(jax.vmap(lambda a: j_kin.all_leg_jacobians(jp, a))(q))
    pairs = [
        (t_kin.foot_positions_in_base_frame(tp, tt(q)), feet),
        (t_kin.joint_angles_from_foot_positions(tp, tt(feet)),
         jax.vmap(lambda p: j_kin.joint_angles_from_foot_positions(jp, p))(
             feet)),
        (t_kin.all_leg_jacobians(tp, tt(q)), jac),
        (t_kin.map_contact_forces_to_torques(tp, tt(q), tt(f)),
         jax.vmap(lambda a, b: j_kin.map_contact_forces_to_torques(
             jp, a, b))(q, f)),
        (t_kin.damped_jacobian_solve(tt(jac), tt(v)),
         j_kin.damped_jacobian_solve(jac, v)),
    ]
    # IK goes through acos/asin near the workspace interior: 1e-4 rad.
    return pairs, dict(rtol=1e-4, atol=1e-4)


def _srb_inputs(seed):
    rng = _rng(seed)
    rpy = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    feet = (rng.normal(size=(B, 4, 3)) * 0.05
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
            ).astype(np.float32)
    x0 = np.concatenate([rng.normal(size=(B, 12)) * 0.05,
                         -9.8 * np.ones((B, 1))], 1).astype(np.float32)
    x_des = np.tile(x0[:, None, :], (1, H, 1))
    x_des[:, :, 9] = 0.4
    return rpy, feet, x0, x_des.astype(np.float32)


def case_srb():
    rpy, feet, x0, _ = _srb_inputs(5)
    tp, jp = a1_params("cpu"), j_a1()
    r = np.asarray(j_se3.rpy_to_rotmat(rpy))
    ja, jb = jax.vmap(lambda rr, ff: j_srb.srb_continuous(
        rr, jp.total_inertia, jp.total_mass, ff))(r, feet)
    jad, jbd = j_srb.srb_discretize(ja, jb, 0.03)
    ta, tb = t_srb.srb_continuous(tt(r), tp.total_inertia, tp.total_mass,
                                  tt(feet))
    tad, tbd = t_srb.srb_discretize(ta, tb, 0.03)
    return [(ta, ja), (tb, jb), (tad, jad), (tbd, jbd),
            (t_srb.srb_initial_state(tt(x0[:, :3]), tt(x0[:, 3:6]),
                                     tt(x0[:, 6:9]), tt(x0[:, 9:12])),
             j_srb.srb_initial_state(x0[:, :3], x0[:, 3:6], x0[:, 6:9],
                                     x0[:, 9:12]))], {}


def case_condense():
    rpy, feet, x0, x_des = _srb_inputs(6)
    jp = j_a1()
    r = np.asarray(j_se3.rpy_to_rotmat(rpy))
    a, b = jax.vmap(lambda rr, ff: j_srb.srb_continuous(
        rr, jp.total_inertia, jp.total_mass, ff))(r, feet)
    ad, bd = j_srb.srb_discretize(a, b, 0.03)
    w = np.array([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                 np.float32)
    jp_s, jq_s = j_condense.condense_cost_structured(
        a, bd, ad, x0, x_des, w, 4e-6, H, 0.03)
    jp_d, jq_d = j_condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, H)
    tp_, tq_ = t_condense.condense_cost_structured(
        tt(a), tt(bd), tt(ad), tt(x0), tt(x_des), tt(w), 4e-6, H, 0.03)
    # Against the generic Toeplitz condensation: same QP in another
    # summation order; entries reach ~1e2, so atol 1e-3.
    return [(tp_, jp_s), (tq_, jq_s), (tp_, jp_d), (tq_, jq_d)], \
        dict(rtol=1e-4, atol=1e-3)


# --- controller and simulator steps from a JAX closed-loop carry -----------

@functools.lru_cache(maxsize=None)
def _carry():
    """JAX state after 50 ticks of the H=5 trot (legs 0 and 3 just lifted
    off), 4 scenarios at vx in {0, .2, .4, .6}, and its port counterpart."""
    cfg = JLC(mpc=j_mpc.MpcConfig(horizon=H, qp_iters=40),
              swing=j_swing.SwingConfig(), gait=JAT())
    params = j_a1()
    vx = jnp.asarray([0.0, 0.2, 0.4, 0.6], jnp.float32)

    def run(v):
        cmd = JTC.constant(vx=v)
        carry, _ = j_rollout.rollout_segment(
            cfg, params, cmd, j_rollout.rollout_init(cfg, params), 50)
        return carry.sim, carry.ctrl

    sim, ctrl = jax.jit(jax.vmap(run))(vx)
    return cfg, sim, ctrl, np.asarray(vx)


def _obs(sim):
    params = j_a1()
    contact = jax.vmap(j_sched.stance_contact_mask)(_carry()[2].gait)
    return jax.vmap(lambda s, c: j_sim.observe(params, s, c))(sim, contact)


def case_gait():
    cfg, sim, ctrl, _ = _carry()
    contact = (_rng(7).random((B, 4)) > 0.3).astype(np.float32)
    t = np.float32(0.102)
    jg = jax.vmap(lambda g, c: j_sched.gait_update(cfg.gait, g, t, c))(
        ctrl.gait, contact)
    tg_in = to_torch(ctrl.gait, t_sched.GaitState, device="cpu")
    tg = t_sched.gait_update(ADVANCED_TROT("cpu"), tg_in, torch.full((B,), t),
                             tt(contact))
    jt = jax.vmap(lambda g: j_sched.predicted_contact_table(
        cfg.gait, g, 0.03, 10))(jg)
    tt_ = t_sched.predicted_contact_table(ADVANCED_TROT("cpu"), tg, 0.03, 10)
    return [(as_numpy(tg), as_numpy(jg)), (tt_, jt)], {}


def case_desired_state():
    _, _, ctrl, vx = _carry()
    rng = _rng(8)
    lin = rng.normal(size=(B, 3)).astype(np.float32)
    wz = rng.normal(size=B).astype(np.float32)
    jcmd = JTC(linear=jnp.asarray(lin), angular_z=jnp.asarray(wz),
               body_height=jnp.full((B,), 0.27, jnp.float32),
               gait_switch=jnp.zeros(B, jnp.float32))
    jd = jax.vmap(j_des.desired_state_update)(ctrl.command, jcmd)
    td = t_des.desired_state_update(
        to_torch(ctrl.command, t_des.DesiredStateCommand, device="cpu"),
        to_torch(jcmd, t_des.TwistCommand, device="cpu"))
    return [(as_numpy(td), as_numpy(jd))], {}


def _port_inputs():
    cfg, sim, ctrl, _ = _carry()
    jobs = _obs(sim)
    return (to_torch(jobs, RobotObservation, device="cpu"),
            to_torch(ctrl, LocomotionState, device="cpu"), jobs)


def case_swing():
    cfg, sim, ctrl, _ = _carry()
    obs, tctrl, jobs = _port_inputs()
    jout = jax.vmap(lambda g, s, o, d: j_swing.swing_step(
        cfg.swing, j_a1(), cfg.gait, g, s, o, d))(
        ctrl.gait, ctrl.swing, jobs, ctrl.command)
    tout = t_swing.swing_step(t_swing.SwingConfig(), a1_params("cpu"),
                              ADVANCED_TROT("cpu"), tctrl.gait, tctrl.swing,
                              obs,
                              tctrl.command)
    # IK and the damped Jacobian solve in the chain: 1e-4.
    return [(as_numpy(tout[3]), as_numpy(jout[3]))] \
        + list(zip(tout[:3], jout[:3])), dict(rtol=1e-4, atol=1e-4)


def _mpc_case(mode):
    cfg, sim, ctrl, _ = _carry()
    obs, tctrl, jobs = _port_inputs()
    jcfg = cfg.mpc.replace(solve_mode=mode)
    tcfg = t_mpc.MpcConfig(horizon=H, qp_iters=40, solve_mode=mode)
    jout = jax.vmap(lambda g, s, o, d, f: j_mpc.mpc_step(
        jcfg, j_a1(), cfg.gait, g, s, o, d, foot_targets_world=f))(
        ctrl.gait, ctrl.mpc, jobs, ctrl.command, ctrl.swing.foot_target_world)
    tout = t_mpc.mpc_step(tcfg, a1_params("cpu"), ADVANCED_TROT("cpu"),
                          tctrl.gait,
                          tctrl.mpc, obs, tctrl.command,
                          foot_targets_world=tctrl.swing.foot_target_world)
    return jout, tout


def case_mpc_solve_tick():
    """Forces and warm primal within 1% m*g, torques within 0.5 N*m, duals
    within 1% of their scale: the warm 40-iteration solve carries the
    single-polish Newton-Schulz rounding differences (see
    test_torch_cone_qp.py); the rest of the state to 1e-5."""
    jout, tout = _mpc_case("always")
    jst, tst = as_numpy(jout[3]), as_numpy(tout[3])
    solved = [(tout[1], jout[1]), (tst.pop("warm_primal"),
                                   jst.pop("warm_primal")),
              (tst.pop("forces_world"), jst.pop("forces_world"))]
    dual_scale = float(np.max(np.abs(jst["warm_dual"])))
    duals = (tst.pop("warm_dual"), jst.pop("warm_dual"))
    jst.pop("warm_pinned"), tst.pop("warm_pinned")
    return [
        ((tst, jst), {}),
        ((tout[2], jout[2]), {}),
        (solved[0], dict(atol=0.01 * MG)),
        (solved[1], dict(atol=0.01 * MG)),
        (solved[2], dict(atol=0.01 * MG)),
        ((tout[0], jout[0]), dict(atol=0.5)),
        (duals, dict(atol=0.01 * dual_scale)),
    ], None


def case_mpc_hold_tick():
    jout, tout = _mpc_case("never")
    return [(as_numpy(tout[3]), as_numpy(jout[3])), (tout[0], jout[0]),
            (tout[1], jout[1]), (tout[2], jout[2])], dict(rtol=1e-5,
                                                          atol=1e-4)


def case_srb_sim_step():
    cfg, sim, ctrl, _ = _carry()
    rng = _rng(9)
    forces = (rng.normal(size=(B, 4, 3)) * 5
              + np.array([0, 0, MG / 2])).astype(np.float32)
    stance = np.asarray(jax.vmap(j_sched.stance_contact_mask)(ctrl.gait))
    q_des = _joints(rng, B)
    dq_des = rng.normal(size=(B, 12)).astype(np.float32)
    swing_mask = 1.0 - np.repeat(stance, 3, axis=-1)
    jnew = jax.vmap(lambda s, f, st, q, dq, sm: j_sim.srb_sim_step(
        j_a1(), s, f, st, q, dq, sm, 0.002))(sim, forces, stance, q_des,
                                             dq_des, swing_mask)
    tnew = t_sim.srb_sim_step(a1_params("cpu"),
                              to_torch(sim, t_sim.SrbSimState, device="cpu"),
                              tt(forces), tt(stance), tt(q_des), tt(dq_des),
                              tt(swing_mask), 0.002)
    # Stance IK + damped Jacobian solve: joint velocities to 1e-3 rad/s.
    return [(as_numpy(tnew), as_numpy(jnew))], dict(rtol=1e-4, atol=1e-3)


CASES = {
    "se3": case_se3, "linalg_inv_spd": case_linalg_inv_spd,
    "splines": case_splines, "kinematics": case_kinematics,
    "srb": case_srb, "condense": case_condense, "gait": case_gait,
    "desired_state": case_desired_state, "swing": case_swing,
    "mpc_solve_tick": case_mpc_solve_tick,
    "mpc_hold_tick": case_mpc_hold_tick, "srb_sim_step": case_srb_sim_step,
}


def _compare(got, want, tol, path="out"):
    if isinstance(want, dict):
        for key, value in want.items():
            _compare(got[key], value, tol, f"{path}.{key}")
        return
    if want is None:
        assert got is None, path
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), err_msg=path,
                               **{"rtol": 1e-5, "atol": 1e-5, **tol})


@pytest.mark.parametrize("name", ["trot", "advanced_trot", "fast_trot",
                                  "walk", "stand", "bound", "pace",
                                  "threestand"])
def test_named_gait_tables(name):
    """Every named gait table, field by field and exactly, and its derived
    periods."""
    ref = j_sched.named_gait(name)
    port = t_sched.named_gait(name, "cpu")
    for key, value in as_numpy(ref).items():
        got = getattr(port, key)
        assert got.numpy().dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    for prop in ("full_cycle_period", "swing_duration", "stance_ratio"):
        np.testing.assert_array_equal(getattr(port, prop).numpy(),
                                      np.asarray(getattr(ref, prop)),
                                      err_msg=prop)


@pytest.mark.parametrize("name", list(CASES))
def test_module_parity(name):
    pairs, tol = CASES[name]()
    if tol is None:  # per-pair tolerances
        for (got, want), pair_tol in pairs:
            _compare(got, want, pair_tol)
    else:
        for got, want in pairs:
            _compare(got, want, tol)
