"""The force-balance stance path of the port against the JAX package.

One parametrised test, one case per ported function: the one-sided Jacobi
SVD, the ADMM QP solver (Ruiz scaling on and off, warm start, per-row rho),
the whitening and the active-set polish, the stance controller
(`compute_contact_forces` on 32 random stance states: 4-, 3- and 2-contact
patterns, `track_xy`, `x_warm`, a tilted surface normal and ramped force
limits; `stance_torques`), the CoM adjuster and the velocity-mode foothold
law. Inputs come from `np.random.default_rng`; JAX functions run under
`jax.jit(jax.vmap(...))` on the CPU where they are written for one scenario.

Tolerance: float32, 1e-5 unless a case states a looser bound and why.

The force-balance forces are held differently (`_hold_forces`). Its QP has
kappa(P) ~ 1e8 and x = P^{-1/2} xi with |P^{-1/2}| = 1/sqrt(reg) = 100, so
the float32 roundoff of two implementations (summation order only) moves
the minimizer by up to ~0.3 N; and the single-pivot polish can meet a
singular active-set Gram matrix (a swing leg's normal row with both of a
tangent's pyramid rows active), whose block-Schur inverse is roundoff, so
on some states a float32 solve misses the minimizer by newtons. Which
states that happens on differs between the two packages (it turns on the
last bits of the whitened rows), at the same rate. So each float32 solve is
held against the same solver in float64 (the port's, which converges on
these states), and: where both float32 solves find the minimizer (within
MISS_N of the float64 one) they agree within AGREE_N; the port misses no
more states than the JAX package, up to the count's noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import stance_force_balance as j_fb
from quadruped_tpu.control import swing as j_swing
from quadruped_tpu.control.desired_state import DesiredStateCommand as JDes
from quadruped_tpu.control.types import RobotObservation as JObs
from quadruped_tpu.core import linalg as j_linalg
from quadruped_tpu.core import se3 as j_se3
from quadruped_tpu.gait import TROT as JTROT
from quadruped_tpu.gait.scheduler import GaitState as JGaitState
from quadruped_tpu.planner import com_adjuster as j_com
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.solvers import polish as j_polish
from quadruped_tpu.solvers import qp as j_qp
from quadruped_tpu_torch.control import stance_force_balance as t_fb
from quadruped_tpu_torch.control import swing as t_swing
from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       DesiredStateCommand)
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import linalg as t_linalg
from quadruped_tpu_torch.core import se3 as t_se3
from quadruped_tpu_torch.gait import TROT
from quadruped_tpu_torch.gait.scheduler import GaitState, LegState
from quadruped_tpu_torch.planner import com_adjuster as t_com
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots import kinematics as t_kin
from quadruped_tpu_torch.solvers import polish as t_polish
from quadruped_tpu_torch.solvers import qp as t_qp
from quadruped_tpu_torch.utils.convert import to_torch

# Stance patterns: all four legs, each 3-leg stance and both trot
# diagonals. The other 2-leg pairs (front, rear, one side) are stances no
# gait of the port holds, and there the reference's own polish misses its
# minimizer on most states (swing-leg forces of tens of newtons).
PATTERNS = np.array([[1, 1, 1, 1], [0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 1],
                     [1, 1, 1, 0], [1, 0, 0, 1], [0, 1, 1, 0]], np.float32)
# Force parity (see the module docstring): a float32 solve "finds" the
# minimizer within MISS_N of the float64 solve; two that find it agree
# within AGREE_N (measured <= 0.33 N over 560 states by
# tests/force_balance_sweep.py). Each package misses on ~9% of such states
# (the same sweep: port 50, JAX 47), so on 16 states either count varies
# by about two: MISS_SLACK.
MISS_N, AGREE_N, MISS_SLACK = 0.25, 0.4, 3
# A slope with roll and pitch (unit normal).
TILTED = np.array([0.15, -0.1, 1.0], np.float32) / np.float32(
    np.linalg.norm([0.15, -0.1, 1.0]))


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rng(seed):
    return np.random.default_rng(seed)


def _compare(got, want, path, **tol):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), err_msg=path,
                               **{"rtol": 1e-5, "atol": 1e-5, **tol})


# --- inputs ------------------------------------------------------------------

def _stance_inputs(n, seed):
    """n random stance states at the size of a trot's errors (attitude
    +-0.05 rad, any yaw, velocities ~0.1): (observation fields,
    desired-state fields) as numpy dicts, the quaternion made from the
    RPY."""
    rng = _rng(seed)
    rpy = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    rpy[:, 2] = rng.uniform(-np.pi, np.pi, n)
    quat = np.asarray(j_se3.rpy_to_quat(rpy))
    r = np.asarray(j_se3.quat_to_rotmat(quat))
    omega_w = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    joints = np.tile(np.array([0.0, 0.67, -1.25], np.float32), 4) \
        + rng.normal(size=(n, 12)).astype(np.float32) * 0.05
    obs = dict(
        base_position=np.c_[rng.normal(size=(n, 2)) * 0.05,
                            0.27 + rng.normal(size=n) * 0.01],
        base_rpy=rpy, base_quat=quat,
        base_vel_world=rng.normal(size=(n, 3)) * 0.1,
        base_omega_world=omega_w,
        base_omega_body=np.einsum("bj,bji->bi", omega_w, r),
        joint_angles=joints,
        joint_velocities=rng.normal(size=(n, 12)),
        foot_contact=np.ones((n, 4)), foot_forces=np.zeros((n, 4)))
    des = dict(
        position=np.c_[rng.normal(size=(n, 2)) * 0.02, np.full(n, 0.27)],
        rpy=np.c_[rng.uniform(-0.03, 0.03, (n, 2)), np.zeros(n)],
        velocity=np.c_[rng.uniform(0.0, 0.4, n), rng.uniform(-0.1, 0.1, n),
                       np.zeros(n)],
        omega=np.c_[np.zeros((n, 2)), rng.uniform(-0.2, 0.2, n)],
        filtered_linear=np.zeros((n, 3)), filtered_wz=np.zeros(n))
    f32 = {k: np.asarray(v, np.float32) for k, v in obs.items()}
    return f32, {k: np.asarray(v, np.float32) for k, v in des.items()}


def _port_obs_des(obs, des):
    return (RobotObservation(**{k: tt(v) for k, v in obs.items()}),
            DesiredStateCommand(**{k: tt(v) for k, v in des.items()}))


def _jax_obs_des(obs, des):
    return (JObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
            JDes(**{k: jnp.asarray(v) for k, v in des.items()}))


def _random_qp(n, m, batch, seed, eq_rows=0):
    """Random strictly convex QPs with a box around a random point, as
    tests/test_qp.py builds them, batched."""
    rng = _rng(seed)
    f = rng.normal(size=(batch, n, n))
    p = f @ f.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.normal(size=(batch, n))
    a = rng.normal(size=(batch, m, n))
    center = np.einsum("bmn,bn->bm", a, rng.normal(size=(batch, n))) * 0.1
    width = np.abs(rng.normal(size=(batch, m))) + 0.5
    l, u = center - width, center + width
    u[:, :eq_rows] = l[:, :eq_rows]
    return tuple(x.astype(np.float32) for x in (p, q, a, l, u))


def _double(x):
    """A dataclass of float32 tensors (params, observation, command) in
    float64."""
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).double()
                                     for f in dataclasses.fields(x)})


def _hold_forces(path, port, ref, f64):
    """Force parity as the module docstring states it: per state, port and
    JAX float32 forces against each other and against the float64 solve."""
    port, ref, f64 = (np.asarray(v, np.float64).reshape(len(v), -1)
                      for v in (port, ref, f64))
    miss_port = np.abs(port - f64).max(-1) > MISS_N
    miss_ref = np.abs(ref - f64).max(-1) > MISS_N
    both = ~miss_port & ~miss_ref
    diff = np.abs(port - ref).max(-1)
    report = (f"{path}: |port - jax| max {diff[both].max():.3g} N where "
              f"both find the minimizer ({both.sum()} of {len(diff)}); "
              f"misses: port {miss_port.sum()}, jax {miss_ref.sum()}")
    assert both.sum() >= 0.75 * len(diff), report
    assert diff[both].max() <= AGREE_N, report
    assert miss_port.sum() <= miss_ref.sum() + MISS_SLACK, report


@functools.lru_cache(maxsize=None)
def _factored_problems():
    """The force-balance QPs of 16 random stance states, as numpy arrays
    (c, q, a, l, u), built by the port (held to JAX in case_stance_*)."""
    obs, des = _stance_inputs(16, 30)
    contacts = PATTERNS[np.arange(16) % len(PATTERNS)]
    tobs, tdes = _port_obs_des(obs, des)
    params = a1_params("cpu")
    cfg = t_fb.ForceBalanceConfig()
    r = tobs.rot_body_to_world
    feet = torch.einsum("bij,blj->bli", r, t_kin.foot_positions_in_base_frame(
        params, tobs.joint_angles) - params.com_offset)
    m6 = t_fb.mass_matrix(params, feet, r)
    target = t_fb.desired_acceleration(cfg, tobs, tdes) \
        + torch.tensor([0, 0, 9.8, 0, 0, 0])
    w = torch.tensor(cfg.acc_weight)
    q = -torch.einsum("bki,bk->bi", m6, w * target)
    c = torch.cat([torch.sqrt(w)[:, None] * m6,
                   torch.full((16, 1, 12), 1e-2)], dim=-2)
    a, l, u = t_fb.build_constraints(
        params, tt(contacts), torch.full((4,), 0.01), torch.full((4,), 10.0),
        torch.tensor([0.0, 0.0, 1.0]))
    return tuple(x.numpy() for x in (c, q, a, l, u))


# --- cases -------------------------------------------------------------------

def case_se3():
    rng = _rng(1)
    rpy = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    q1 = np.asarray(j_se3.rpy_to_quat(rpy))
    q2 = np.asarray(j_se3.rpy_to_quat(
        rpy + rng.normal(size=(8, 3)).astype(np.float32) * 0.3))
    return [(t_se3.rpy_to_quat(tt(rpy)), q1, {}),
            (t_se3.quat_error_so3(tt(q2), tt(q1)),
             j_se3.quat_error_so3(q2, q1), {})]


def case_jacobi_svd():
    """Tall [12, 7] matrices: graded ones (columns scaled 1e2 .. 1e-2, where
    one-sided Jacobi keeps high relative accuracy), random ones, and the
    force-balance factors C^T. The same rotations in the same order: s to
    rtol 1e-5 above a floor of 1e-6 s_max (C has rank 6: its seventh value
    is roundoff, ~1e-9, and its column of u is arbitrary), u to 1e-5 on the
    columns above that floor."""
    rng = _rng(2)
    mats = np.concatenate([
        rng.normal(size=(4, 12, 7)) * np.logspace(2, -2, 7),
        rng.normal(size=(2, 12, 7)),
        _factored_problems()[0][:4].transpose(0, 2, 1)]).astype(np.float32)
    tu, ts = (x.numpy() for x in t_linalg.onesided_jacobi_svd(tt(mats)))
    ju, js = (np.asarray(x) for x in
              jax.jit(j_linalg.onesided_jacobi_svd)(mats))
    floor = 1e-6 * js.max(-1, keepdims=True)
    assert np.all(np.abs(ts - js) <= 1e-5 * js + floor), \
        np.abs(ts - js).max()
    live = np.broadcast_to((js > floor)[:, None, :], ju.shape)
    return [(tu[live], ju[live], {})]


def case_admm():
    """admm_solve with Ruiz scaling on and off, a warm (x0, y0) with a
    per-row rho, and kkt_residuals, on random QPs with an equality row. The
    float32 roundoff of the solve: against a float64 run of the same
    iterations x lands within 2e-3 on either side, y (|y| ~0.9) within
    1.3e-2 (port) and 4e-3 (JAX), and JAX jitted against JAX eager differ
    by 1.7e-3 in x and 7e-3 in y (measured); held to 5e-3 and, for y,
    2e-2. The dual and KKT residuals are float32 floors (1e-3 .. 4e-2 on
    either side, below 4e-5 in float64): held to 5e-2."""
    tol = dict(rtol=1e-3, atol=5e-3)
    tol_y = dict(rtol=1e-3, atol=2e-2)
    tol_res = dict(rtol=0, atol=5e-2)
    field_tol = {"y": tol_y, "dual_res": tol_res}
    out = []
    data = _random_qp(8, 6, 4, seed=3, eq_rows=1)
    tdata = [tt(x) for x in data]
    for scale in (True, False):
        tsol = t_qp.admm_solve(*tdata, iters=80, scale=scale)
        jsol = jax.jit(jax.vmap(lambda *x: j_qp.admm_solve(
            *x, iters=80, scale=scale)))(*data)
        out += [(getattr(tsol, f), getattr(jsol, f), field_tol.get(f, tol))
                for f in t_qp.QPSolution._fields]
        out.append((torch.stack(t_qp.kkt_residuals(*tdata, tsol)),
                    jnp.stack(jax.vmap(j_qp.kkt_residuals)(*data, jsol)),
                    tol_res))
    # Warm start with a per-row rho vector.
    rng = _rng(4)
    x0 = rng.normal(size=(4, 8)).astype(np.float32)
    y0 = rng.normal(size=(4, 6)).astype(np.float32) * 0.1
    rho = rng.uniform(0.05, 0.5, (4, 6)).astype(np.float32)
    tsol = t_qp.admm_solve(*tdata, iters=40, rho=tt(rho), x0=tt(x0),
                           y0=tt(y0))
    jsol = jax.jit(jax.vmap(lambda p_, q_, a_, l_, u_, r_, x_, y_:
                            j_qp.admm_solve(p_, q_, a_, l_, u_, iters=40,
                                            rho=r_, x0=x_, y0=y_)))(
        *data, rho, x0, y0)
    out += [(getattr(tsol, f), getattr(jsol, f), field_tol.get(f, tol))
            for f in t_qp.QPSolution._fields]
    out.append((t_qp.default_rho(tdata[3], tdata[4]),
                j_qp.default_rho(data[3], data[4]), {}))
    return out


def case_polish():
    """whiten_factors (P^{1/2} to 1e-4, P^{-1/2}, entries up to 1e2, to
    1e-4 relative) and solve_factored from a warm start on the force-balance
    QPs of 16 stance states, held as _hold_forces states."""
    c, q, a, l, u = _factored_problems()
    tph, tpi = t_polish.whiten_factors(tt(c), 1e-4)
    jph, jpi = jax.vmap(lambda c_: j_polish.whiten_factors(c_, 1e-4))(c)
    x_warm = _rng(5).normal(size=q.shape).astype(np.float32) * 5
    x_warm[:, 2::3] += 30.0
    jx = jax.jit(jax.vmap(
        lambda c_, q_, a_, l_, u_, x_: j_polish.solve_factored(
            j_polish.FactoredQP(c=c_, reg=1e-4, q=q_, a=a_, l=l_, u=u_),
            admm_iters=64, polish_passes=24, x0=x_)))(c, q, a, l, u, x_warm)
    tx, tx64 = (t_polish.solve_factored(
        t_polish.FactoredQP(c=cast(c), reg=1e-4, q=cast(q), a=cast(a),
                            l=cast(l), u=cast(u)),
        admm_iters=64, polish_passes=24, x0=cast(x_warm))
        for cast in (tt, lambda v: torch.from_numpy(v).double()))
    _hold_forces("solve_factored", tx, jx, tx64)
    return [(tph, jph, dict(rtol=1e-4, atol=1e-4)),
            (tpi, jpi, dict(rtol=1e-4, atol=1e-2))]


def _forces_case(n, seed, *, track_xy, warm, normal, ramp):
    """compute_contact_forces of the port (float32 and float64) and of JAX
    on n random stance states; returns (port forces, JAX forces, port
    observations, JAX observations, contacts)."""
    obs, des = _stance_inputs(n, seed)
    contacts = PATTERNS[(np.arange(n) + seed) % len(PATTERNS)]
    opt = {}
    if ramp:  # walk-style load/unload ramps per leg
        opt["f_max_ratio"] = np.linspace(0.2, 10.0, 4 * n,
                                         dtype=np.float32).reshape(n, 4)
    if warm:
        opt["x_warm"] = np.zeros((n, 4, 3), np.float32)
        opt["x_warm"][..., 2] = 30.0 * contacts
    if normal is not None:
        opt["surface_normal"] = normal
    tobs, tdes = _port_obs_des(obs, des)
    tcfg = t_fb.ForceBalanceConfig(track_xy=track_xy)
    params = a1_params("cpu")
    tf = t_fb.compute_contact_forces(tcfg, params, tobs, tdes, tt(contacts),
                                     **{k: tt(v) for k, v in opt.items()})
    f64 = t_fb.compute_contact_forces(
        tcfg, _double(params), _double(tobs), _double(tdes),
        tt(contacts).double(),
        f_min_ratio=torch.full((4,), 0.01, dtype=torch.float64),
        **{k: tt(v).double() for k, v in opt.items()})
    jcfg = j_fb.ForceBalanceConfig(track_xy=track_xy)
    normal_j = None if normal is None else jnp.asarray(normal)

    def one(o, d, c, fm, xw):
        return j_fb.compute_contact_forces(jcfg, j_a1(), o, d, c,
                                           f_max_ratio=fm,
                                           surface_normal=normal_j,
                                           x_warm=xw)

    jobs, jdes = _jax_obs_des(obs, des)
    fm, xw = opt.get("f_max_ratio"), opt.get("x_warm")
    jf = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None if fm is None else 0,
                                        None if xw is None else 0)))(
        jobs, jdes, contacts, fm, xw)
    _hold_forces(f"compute_contact_forces(seed {seed})", tf, jf, f64)
    return tf, jf, tobs, jobs, contacts


def case_stance_default():
    """compute_contact_forces on 16 states at ForceBalanceConfig() on flat
    ground (held as _hold_forces states), and stance_torques of the same
    forces on both sides to 1e-4."""
    _, jf, tobs, jobs, contacts = _forces_case(
        16, 10, track_xy=False, warm=False, normal=None, ramp=False)
    jtau = jax.vmap(lambda o, f, c: j_fb.stance_torques(j_a1(), o, f, c))(
        jobs, jf, contacts)
    return [(t_fb.stance_torques(a1_params("cpu"), tobs, tt(np.asarray(jf)),
                                 tt(contacts)),
             jtau, dict(rtol=1e-4, atol=1e-4))]


def case_stance_variants():
    """compute_contact_forces on 16 more states with track_xy, a warm start
    (x_warm), a tilted surface normal and per-leg ramped f_max_ratio, all at
    once (held as _hold_forces states)."""
    _forces_case(16, 20, track_xy=True, warm=True, normal=TILTED, ramp=True)
    return []


def case_stance_pieces():
    """desired_acceleration (both track_xy), mass_matrix (world and base
    frame) and build_constraints (tilted normal, ramped limits)."""
    obs, des = _stance_inputs(8, 40)
    tobs, tdes = _port_obs_des(obs, des)
    jobs, jdes = _jax_obs_des(obs, des)
    out = []
    for track in (False, True):
        out.append((t_fb.desired_acceleration(
            t_fb.ForceBalanceConfig(track_xy=track), tobs, tdes),
            jax.vmap(lambda o, d: j_fb.desired_acceleration(
                j_fb.ForceBalanceConfig(track_xy=track), o, d))(jobs, jdes),
            dict(rtol=1e-5, atol=1e-4)))
    feet = _rng(41).normal(size=(8, 4, 3)).astype(np.float32) * 0.2
    r = np.asarray(j_se3.quat_to_rotmat(obs["base_quat"]))
    out.append((t_fb.mass_matrix(a1_params("cpu"), tt(feet), tt(r)),
                jax.vmap(lambda f, r_: j_fb.mass_matrix(j_a1(), f, r_))(
                    feet, r), {}))
    out.append((t_fb.mass_matrix(a1_params("cpu"), tt(feet)),
                jax.vmap(lambda f: j_fb.mass_matrix(j_a1(), f))(feet), {}))
    contacts = PATTERNS[np.arange(8) % len(PATTERNS)]
    f_max = np.linspace(0.2, 10.0, 32, dtype=np.float32).reshape(8, 4)
    t_out = t_fb.build_constraints(a1_params("cpu"), tt(contacts),
                                   torch.full((4,), 0.01), tt(f_max),
                                   tt(TILTED))
    j_out = jax.vmap(lambda c, f: j_fb.build_constraints(
        j_a1(), c, jnp.full((4,), 0.01), f, jnp.asarray(TILTED)))(
        contacts, f_max)
    out += [(t, j, {}) for t, j in zip(t_out, j_out)]
    return out


def _gait_state(rng, n):
    """A GaitState of n scenarios with random phases and leg states (the
    fields the CoM adjuster reads; the rest zero)."""
    z = np.zeros((n, 4), np.float32)
    fields = {f: z for f in ("normalized_phase", "phase_in_full_cycle",
                             "first_swing", "swing_time_remaining",
                             "allow_switch")}
    fields.update({f: np.zeros((n, 4), np.int32) for f in (
        "leg_state", "cur_leg_state", "last_leg_state", "desired_leg_state")})
    fields.update({f: np.zeros(n, np.float32) for f in (
        "reset_time", "cum_wait", "last_time")})
    fields["normalized_phase"] = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    fields["leg_state"] = rng.choice(
        [LegState.SWING, LegState.STANCE, LegState.EARLY_CONTACT,
         LegState.LOSE_CONTACT], (n, 4)).astype(np.int32)
    return JGaitState(**{k: jnp.asarray(v) for k, v in fields.items()})


def case_com_adjuster():
    rng = _rng(50)
    jg = _gait_state(rng, 16)
    feet = (np.array([[0.18, -0.13, -0.27], [0.18, 0.13, -0.27],
                      [-0.18, -0.13, -0.27], [-0.18, 0.13, -0.27]])
            + rng.normal(size=(16, 4, 3)) * 0.03).astype(np.float32)
    tg = to_torch(jg, GaitState)
    return [(t_com.contact_weights(tg), j_com.contact_weights(jg), {}),
            (t_com.com_position_in_base_frame(tg, tt(feet)),
             jax.vmap(j_com.com_position_in_base_frame)(jg, feet), {})]


def case_foothold_velocity_mode():
    obs, des = _stance_inputs(8, 60)
    tobs, tdes = _port_obs_des(obs, des)
    jobs, jdes = _jax_obs_des(obs, des)
    jcfg = j_swing.SwingConfig(mode=ControlMode.VELOCITY)
    tcfg = t_swing.SwingConfig(mode=ControlMode.VELOCITY)
    return [(t_swing.raibert_foothold_velocity_mode(
        tcfg, a1_params("cpu"), TROT("cpu"), tobs, tdes),
        jax.vmap(lambda o, d: j_swing.raibert_foothold_velocity_mode(
            jcfg, j_a1(), JTROT(), o, d))(jobs, jdes), {})]


CASES = {"se3": case_se3, "jacobi_svd": case_jacobi_svd, "admm": case_admm,
         "polish": case_polish, "stance_default": case_stance_default,
         "stance_variants": case_stance_variants,
         "stance_pieces": case_stance_pieces,
         "com_adjuster": case_com_adjuster,
         "foothold_velocity_mode": case_foothold_velocity_mode}


@pytest.mark.parametrize("name", list(CASES))
def test_force_balance_parity(name):
    for i, (got, want, tol) in enumerate(CASES[name]()):
        _compare(got, want, f"{name}[{i}]", **tol)
