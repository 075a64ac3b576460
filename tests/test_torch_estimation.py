"""The port's estimation stack against the JAX package (CPU): the moving
window, `foot_velocities_in_base_frame`, the velocity, pose, ground,
contact and ZMP estimators, the container over a sensor stream recorded
from a JAX whole-body run, and the optional 18-state CMU filter; then the
physical checks of tests/test_estimation.py and tests/test_cmu_kf.py on
the port alone.

Inputs come from numpy seeds; each JAX function runs under `jax.jit` of
`jax.vmap` (the JAX package's estimators are written per robot, and the
runner compiles them: XLA turns a division by a constant into a product
with its float32 reciprocal, which the port mirrors). Latched flags
(contact, slip, plane refit) must be equal. Continuous outputs are held to
TOL, max |port - JAX| with the CPU reading beside each: float32 in two
summation orders, and `torch.special.erf` against `jax.scipy.special.erf`,
which differ by up to ERF_GAP (4 ulp; 2.98e-7 at most on 1e5 samples
of N(0, 2)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.core import filters as jfilt
from quadruped_tpu.estimation import cmu_kf as jcmu
from quadruped_tpu.estimation import contact as jcon
from quadruped_tpu.estimation import container as jcont
from quadruped_tpu.estimation import ground as jground
from quadruped_tpu.estimation import pose as jpose
from quadruped_tpu.estimation import velocity as jvel
from quadruped_tpu.estimation import zmp as jzmp
from quadruped_tpu.robots import a1_params as ja1
from quadruped_tpu.robots import kinematics as jkin
from quadruped_tpu_torch.core import filters, se3
from quadruped_tpu_torch.estimation import cmu_kf, contact, ground, pose
from quadruped_tpu_torch.estimation import velocity, zmp
from quadruped_tpu_torch.estimation.container import (EstimatorConfig,
                                                      EstimatorState,
                                                      RawSensors,
                                                      estimator_init,
                                                      estimator_update)
from quadruped_tpu_torch.robots import a1_params, kinematics
from quadruped_tpu_torch.utils.convert import as_numpy, to_torch

torch.set_num_threads(1)

B = 8
DT = 0.002
STREAM_TICKS = 200
ERF_GAP = 3e-7
# max |port - JAX| (CPU reading).
TOL = {
    "foot_velocities": 5e-6,      # 4.8e-7 (up to ~10 m/s)
    "velocity": 1e-6,             # 1.2e-7 over 30 ticks (v and cov)
    "pose": 1e-6,                 # 3.0e-8
    "plane": 1e-6,                # 1.3e-7 (coefficients up to ~0.5)
    "ground_frame": 2e-6,         # 1.8e-7
    "phase_prior": 2 * ERF_GAP,   # 1.5e-7
    "p_contact": 2e-6,            # 1.8e-7 over 40 ticks
    "knee": 5e-6,                 # 4.8e-7 (up to ~40 N m)
    "clip": 1e-6,                 # 3.0e-8
    "zmp": 1e-6,                  # 1.5e-8
    # The container over the 200-tick stream.
    "stream_position": 1e-6,      # 6.0e-8 m
    "stream_velocity": 5e-6,      # 4.8e-7 m/s
    "stream_p_contact": 5e-6,     # 5.4e-7
    "stream_frame": 2e-6,         # 1.5e-7
    # The CMU filter over 200 ticks ([28, 28] solves in two LAPACK calls).
    "cmu_x": 3e-5,                # 2.8e-6 (positions and velocities)
    "cmu_cov": 2e-4,              # 1.9e-5 (entries up to 3)
}


def tt(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _stand_joints(rng, batch=B, scale=0.05):
    return (np.tile(np.asarray(ja1().stand_angles), (batch, 1))
            + rng.normal(0.0, scale, (batch, 12))).astype(np.float32)


def _quats(rng, batch=B, scale=0.05):
    rpy = rng.normal(0.0, scale, (batch, 3)).astype(np.float32)
    return se3.rpy_to_quat(tt(rpy)).numpy()


# --- moving window and kinematics -------------------------------------------

@pytest.mark.parametrize("window,ticks", [(20, 7), (5, 23)])
def test_moving_window_matches_jax(window, ticks):
    """A partial fill (7 of 20) and three wraps of a 5-window: the means
    are the same float32 numbers, tick by tick, and so is the state."""
    rng = np.random.default_rng(window)
    xs = rng.normal(0.0, 1.0, (ticks, B, 4, 3)).astype(np.float32)

    def scan(xs):
        def step(s, x):
            s, m = jax.vmap(jfilt.moving_window_update)(s, x)
            return s, m
        s0 = jax.vmap(lambda _: jfilt.moving_window_init(window, (4, 3)))(
            jnp.arange(B))
        return jax.lax.scan(step, s0, xs)

    js, jm = jax.jit(scan)(jnp.asarray(xs))
    s = filters.moving_window_init(B, window, (4, 3), "cpu")
    for k in range(ticks):
        s, m = filters.moving_window_update(s, tt(xs[k]))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm[k]))
    carried = to_torch(js, filters.MovingWindowState, device="cpu")
    for f in ("buf", "idx", "count"):
        assert torch.equal(getattr(carried, f), getattr(s, f)), f


def test_foot_velocities_in_base_frame():
    rng = np.random.default_rng(1)
    q = _stand_joints(rng, scale=0.3)
    dq = rng.normal(0.0, 3.0, (B, 12)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b: jkin.foot_velocities_in_base_frame(
        ja1(), a, b)))(q, dq)
    got = kinematics.foot_velocities_in_base_frame(a1_params("cpu"), tt(q),
                                                   tt(dq))
    assert got.shape == (B, 4, 3)
    assert _max(got, want) <= TOL["foot_velocities"]


# --- velocity, pose, ground --------------------------------------------------

def _vel_inputs(rng, ticks):
    return dict(
        acc_body=(rng.normal(0.0, 0.5, (ticks, B, 3))
                  + np.array([0.0, 0.0, 9.81])).astype(np.float32),
        quat=np.stack([_quats(rng) for _ in range(ticks)]),
        omega_body=rng.normal(0.0, 0.3, (ticks, B, 3)).astype(np.float32),
        joint_angles=np.stack([_stand_joints(rng) for _ in range(ticks)]),
        joint_velocities=rng.normal(0.0, 1.0, (ticks, B, 12)).astype(
            np.float32),
        foot_contact=(rng.random((ticks, B, 4)) < 0.6).astype(np.float32))


def test_velocity_estimator_matches_jax():
    """30 ticks of random IMU and leg readings (one scenario with no foot
    in contact on some ticks), window 20 / acc window 5 (partly filled)."""
    ticks = 30
    rng = np.random.default_rng(2)
    ins = _vel_inputs(rng, ticks)
    ins["foot_contact"][:, 0] = 0.0
    jcfg = jvel.VelocityEstimatorConfig(window_size=20, acc_filter_window=5)
    cfg = velocity.VelocityEstimatorConfig(window_size=20,
                                           acc_filter_window=5)

    def scan(ins):
        def step(s, x):
            s = jax.vmap(lambda s, x: jvel.velocity_estimator_update(
                jcfg, ja1(), s, dt=DT, **x))(s, x)
            return s, s
        s0 = jax.vmap(lambda _: jvel.velocity_estimator_init(jcfg))(
            jnp.arange(B))
        return jax.lax.scan(step, s0, ins)[1]

    want = jax.jit(scan)({k: jnp.asarray(v) for k, v in ins.items()})
    s = velocity.velocity_estimator_init(cfg, B, "cpu")
    p = a1_params("cpu")
    for k in range(ticks):
        s = velocity.velocity_estimator_update(
            cfg, p, s, dt=DT, **{n: tt(v[k]) for n, v in ins.items()})
        for f in ("v_world", "smoothed_v_world", "cov"):
            assert _max(getattr(s, f), getattr(want, f)[k]) \
                <= TOL["velocity"], (k, f)


def test_pose_estimator_matches_jax():
    rng = np.random.default_rng(3)
    p = a1_params("cpu")
    feet = kinematics.foot_positions_in_base_frame(
        p, tt(_stand_joints(rng))).numpy()
    stance = (rng.random((B, 4)) < 0.7).astype(np.float32)
    stance[0] = 0.0
    ins = dict(quat=_quats(rng), foot_positions_base=feet,
               desired_stance=stance,
               v_base=rng.normal(0.0, 0.5, (B, 3)).astype(np.float32),
               yaw_rate=rng.normal(0.0, 0.5, B).astype(np.float32),
               ground_rot=se3.rpy_to_rotmat(tt(rng.normal(
                   0.0, 0.1, (B, 3)))).numpy())
    jst = jax.vmap(lambda h: jpose.pose_estimator_init(h))(
        jnp.asarray(rng.uniform(0.2, 0.3, B), jnp.float32))
    jst = jst.replace(yaw_odom=jnp.asarray(rng.normal(0, 1, B), jnp.float32),
                      position=jst.position.at[:, :2].set(
                          rng.normal(0, 1, (B, 2))))
    want = jax.jit(jax.vmap(lambda s, x: jpose.pose_estimator_update(
        s, body_height=ja1().body_height, dt=DT, **x)))(jst, ins)
    got = pose.pose_estimator_update(
        to_torch(jst, pose.PoseEstimatorState, device="cpu"),
        body_height=a1_params("cpu").body_height, dt=DT,
        **{k: tt(v) for k, v in ins.items()})
    for f in ("position", "yaw_odom", "height_in_control"):
        assert _max(getattr(got, f), getattr(want, f)) <= TOL["pose"], f


FEET = np.array([[0.17, -0.13, -0.3], [0.17, 0.13, -0.3],
                 [-0.17, -0.13, -0.3], [-0.17, 0.13, -0.3]], np.float32)


def test_fit_plane_flat_and_sloped():
    """The port of test_ground_plane_fit_flat_and_slope, and random
    sloped fits against JAX."""
    np.testing.assert_allclose(ground.fit_plane(tt(FEET)).numpy(),
                               [-0.3, 0.0, 0.0], atol=1e-5)
    slope = FEET.copy()
    slope[:, 2] = -0.3 + 0.2 * FEET[:, 0]
    np.testing.assert_allclose(ground.fit_plane(tt(slope)).numpy(),
                               [-0.3, 0.2, 0.0], atol=1e-5)
    rng = np.random.default_rng(4)
    feet = FEET[None] + rng.normal(0.0, 0.02, (B, 4, 3)).astype(np.float32)
    feet[..., 2] += (rng.uniform(-0.3, 0.3, (B, 1)) * feet[..., 0]
                     + rng.uniform(-0.3, 0.3, (B, 1)) * feet[..., 1])
    want = jax.jit(jground.fit_plane)(feet)
    assert _max(ground.fit_plane(tt(feet)), want) <= TOL["plane"]


def test_ground_estimator_matches_jax_and_refits_on_touchdown_only():
    """20 ticks of moving feet and random contact patterns (touch-downs
    with all four feet down, touch-downs with three, no touch-down): the
    refit ticks and the plane are JAX's, and the plane changes only on a
    four-contact touch-down."""
    ticks = 20
    rng = np.random.default_rng(5)
    feet = (FEET[None, None] + rng.normal(0.0, 0.03, (ticks, B, 4, 3))
            ).astype(np.float32)
    contact_in = (rng.random((ticks, B, 4)) < 0.75).astype(np.float32)
    contact_in[::3] = 1.0
    quats = np.stack([_quats(rng) for _ in range(ticks)])

    def scan(xs):
        def step(s, x):
            s = jax.vmap(jground.ground_estimator_update)(s, *x)
            return s, s
        s0 = jax.vmap(lambda _: jground.ground_estimator_init())(
            jnp.arange(B))
        return jax.lax.scan(step, s0, xs)[1]

    want = jax.jit(scan)((feet, contact_in, quats))
    s = ground.ground_estimator_init(B, "cpu")
    refits = 0
    for k in range(ticks):
        prev = s.plane_coefs
        s = ground.ground_estimator_update(s, tt(feet[k]), tt(contact_in[k]),
                                           tt(quats[k]))
        changed = (s.plane_coefs != prev).any(-1).numpy()
        touch = (contact_in[k] * (1 - (contact_in[k - 1] if k else 0))
                 ).max(-1) > 0.5
        allc = contact_in[k].sum(-1) > 3.5
        np.testing.assert_array_equal(changed & ~(touch & allc), False)
        refits += int(changed.sum())
        assert _max(s.plane_coefs, want.plane_coefs[k]) <= TOL["plane"], k
        for f in ("normal_world", "control_rpy", "ground_rot",
                  "base_r_in_control"):
            assert _max(getattr(s, f), getattr(want, f)[k]) \
                <= TOL["ground_frame"], (k, f)
    assert refits > B


def test_ground_estimator_updates_on_touchdown_only():
    """The port of test_ground_estimator_updates_on_touchdown_only."""
    s = ground.ground_estimator_init(1, "cpu")
    quat = tt([[1.0, 0, 0, 0]])
    s1 = ground.ground_estimator_update(s, tt(FEET[None]), torch.ones(1, 4),
                                        quat)
    np.testing.assert_allclose(s1.plane_coefs[0].numpy(), [-0.3, 0, 0],
                               atol=1e-5)
    feet2 = FEET.copy()
    feet2[:, 2] = -0.5
    s2 = ground.ground_estimator_update(s1, tt(feet2[None]),
                                        torch.ones(1, 4), quat)
    assert torch.equal(s2.plane_coefs, s1.plane_coefs)


# --- contact -----------------------------------------------------------------

def test_erf_gap_and_phase_prior():
    """The two erf approximations differ by up to ERF_GAP; the prior
    inherits that gap."""
    x = np.random.default_rng(6).normal(0.0, 2.0, 100000).astype(np.float32)
    gap = _max(torch.special.erf(tt(x)), jax.jit(jax.scipy.special.erf)(x))
    assert gap <= ERF_GAP
    rng = np.random.default_rng(7)
    phi = rng.random((B, 4)).astype(np.float32)
    stance = (rng.random((B, 4)) < 0.5).astype(np.float32)
    want = jax.jit(jax.vmap(jcon.phase_prior))(phi, stance)
    assert _max(contact.phase_prior(tt(phi), tt(stance)), want) \
        <= TOL["phase_prior"]


def test_contact_phase_prior_windows():
    """The port of test_contact_phase_prior_windows."""
    prior = contact.phase_prior(tt([[0.5, 0.02, 0.5, 0.98]]),
                                tt([[1.0, 1.0, 0.0, 0.0]]))[0]
    assert prior[0] > 0.99
    assert 0.3 < prior[1] < 0.7
    assert prior[2] < 0.01
    assert 0.3 < prior[3] < 0.7


def _contact_inputs(rng, ticks):
    phase = (np.arange(ticks)[:, None, None] * 0.04
             + rng.random((1, B, 4))) % 1.0
    stance = ((np.arange(ticks)[:, None, None] // 12
               + np.arange(4)[None, None, :]) % 2).astype(np.float32)
    stance = np.broadcast_to(stance, (ticks, B, 4))
    return dict(
        normalized_phase=phase.astype(np.float32),
        in_stance=np.ascontiguousarray(stance),
        foot_height_above_ground=(rng.normal(0.0, 0.03, (ticks, B, 4))
                                  * (1 - stance)).astype(np.float32),
        foot_velocities_base=rng.normal(0.0, 0.3, (ticks, B, 4, 3)).astype(
            np.float32),
        foot_forces=(rng.uniform(0.0, 60.0, (ticks, B, 4)) * stance).astype(
            np.float32),
        base_v_control=rng.normal(0.0, 0.2, (ticks, B, 3)).astype(
            np.float32))


def test_contact_detection_matches_jax():
    """40 ticks of alternating stance and swing with noisy evidence: the
    latched contact and slip flags are JAX's on every tick (both latches
    switch in the run), the posterior within TOL."""
    ticks = 40
    ins = _contact_inputs(np.random.default_rng(8), ticks)

    def scan(xs):
        def step(s, x):
            s = jax.vmap(lambda s, x: jcon.contact_detection_update(
                s, **x))(s, x)
            return s, s
        s0 = jax.vmap(lambda _: jcon.contact_detection_init())(
            jnp.arange(B))
        return jax.lax.scan(step, s0, xs)[1]

    want = jax.jit(scan)({k: jnp.asarray(v) for k, v in ins.items()})
    s = contact.contact_detection_init(B, device="cpu")
    flips = {"is_contact": 0, "is_slip": 0}
    for k in range(ticks):
        prev = s
        s = contact.contact_detection_update(
            s, **{n: tt(v[k]) for n, v in ins.items()})
        for f in flips:
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(want, f)[k]),
                                          err_msg=f"{f} tick {k}")
            flips[f] += int((getattr(s, f) != getattr(prev, f)).sum())
        assert _max(s.p_contact, want.p_contact[k]) <= TOL["p_contact"], k
        assert _max(s.p_slip, want.p_slip[k]) <= TOL["p_contact"], k
    assert flips["is_contact"] > 10 and flips["is_slip"] > 2, flips


def test_contact_detector_tracks_forces():
    """The port of test_contact_detector_tracks_forces."""
    s = contact.contact_detection_init(1, device="cpu")
    vel = torch.zeros(1, 4, 3)
    vel[0, 1, 2] = 0.3
    for _ in range(30):
        s = contact.contact_detection_update(
            s, normalized_phase=torch.full((1, 4), 0.5),
            in_stance=tt([[1.0, 0.0, 1.0, 1.0]]),
            foot_height_above_ground=tt([[0.0, 0.08, 0.0, 0.0]]),
            foot_velocities_base=vel,
            foot_forces=tt([[40.0, 0.0, 40.0, 40.0]]),
            base_v_control=torch.zeros(1, 3))
    assert s.is_contact[0, 0] == 1.0
    assert s.is_contact[0, 1] == 0.0
    assert s.p_contact[0, 1] < 0.3


def test_external_knee_torque_and_workspace_clip_match_jax():
    rng = np.random.default_rng(9)
    tau = rng.normal(0.0, 10.0, (B, 12)).astype(np.float32)
    ddq = rng.normal(0.0, 50.0, (B, 12)).astype(np.float32)
    want = jax.jit(lambda a, b: jcon.external_knee_torque(ja1(), a, b))(
        tau, ddq)
    got = contact.external_knee_torque(a1_params("cpu"), tt(tau), tt(ddq))
    assert _max(got, want) <= TOL["knee"]
    feet = (FEET[None] + rng.normal(0.0, 0.15, (B, 4, 3))).astype(np.float32)
    allowed = np.asarray([0.2, 0.2, 0.35], np.float32)
    wc, wo = jax.jit(lambda f: jcon.workspace_clip(ja1(), f, allowed))(feet)
    gc, go = contact.workspace_clip(a1_params("cpu"), tt(feet), tt(allowed))
    assert _max(gc, wc) <= TOL["clip"]
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    assert 0 < go.sum() < go.numel()


def test_external_knee_torque_zero_in_free_swing():
    """The port of test_external_knee_torque_zero_in_free_swing."""
    p = a1_params("cpu")
    ddq = torch.zeros(12)
    ddq[2::3] = 3.0
    m, length = p.links_mass[2], p.lower_length
    iyy = p.links_inertia[2, 1, 1] + m * length * length
    tau_free = torch.zeros(12)
    tau_free[2::3] = iyy * 3.0 + m * 9.8 * length
    np.testing.assert_allclose(
        contact.external_knee_torque(p, tau_free, ddq).numpy(), 0.0,
        atol=1e-5)
    np.testing.assert_allclose(
        contact.external_knee_torque(p, tau_free + 5.0, ddq).numpy(), -5.0,
        atol=1e-4)


def test_workspace_clip_box():
    """The port of test_workspace_clip_box."""
    p = a1_params("cpu")
    allowed = tt([0.2, 0.2, 0.35])
    offset = p.default_hip_position.clone()
    offset[:, 2] = -p.body_height
    inside = offset + tt([0.05, 0.0, 0.1])
    clipped, outside = contact.workspace_clip(p, inside, allowed)
    np.testing.assert_allclose(clipped.numpy(), inside.numpy(), atol=1e-6)
    assert outside.sum() == 0
    clipped, outside = contact.workspace_clip(p, offset + tt([0.4, 0.1, 0.1]),
                                              allowed)
    rel = (clipped - offset).numpy()
    np.testing.assert_allclose(rel[:, 0], 0.2, atol=1e-6)
    np.testing.assert_allclose(rel[:, 1], 0.05, atol=1e-6)
    assert outside.sum() == 4
    assert np.all(np.abs(rel) <= allowed.numpy() + 1e-6)


# --- zmp ---------------------------------------------------------------------

def test_zmp_matches_jax():
    rng = np.random.default_rng(10)
    com = (rng.normal(0.0, 0.1, (B, 3)) + [0, 0, 0.28]).astype(np.float32)
    acc = rng.normal(0.0, 1.0, (B, 3)).astype(np.float32)
    feet = (FEET[None] + rng.normal(0.0, 0.03, (B, 4, 3))).astype(np.float32)
    con = (rng.random((B, 4)) < 0.7).astype(np.float32)
    z = jax.jit(jzmp.compute_zmp)(com, acc)
    assert _max(zmp.compute_zmp(tt(com), tt(acc)), z) <= TOL["zmp"]
    want = jax.jit(jzmp.support_margin)(np.asarray(z), feet, con)
    got = zmp.support_margin(tt(np.asarray(z)), tt(feet), tt(con))
    assert _max(got, want) <= TOL["zmp"]


# --- the container over a JAX whole-body sensor stream -----------------------

PERIOD = 0.3           # s, the open-loop trot of the recorded stream
LEG_OFFSET = np.array([0.0, 0.5, 0.5, 0.0])


def _schedule(ticks):
    """Phase and stance of a 0.3 s trot clock, the same for the batch."""
    t = (np.arange(ticks) + 1)[:, None] * DT / PERIOD + LEG_OFFSET
    ph = t % 1.0
    stance = (ph < 0.5).astype(np.float32)
    norm = np.where(stance > 0.5, ph / 0.5, (ph - 0.5) / 0.5)
    return (np.broadcast_to(norm[:, None], (ticks, B, 4)).astype(np.float32),
            np.broadcast_to(stance[:, None], (ticks, B, 4)).copy())


@functools.lru_cache(maxsize=None)
def _jax_stream():
    """Raw sensors of a JAX whole-body run at B=8: the A1 from its stand
    pose under an open-loop trot of joint targets (diagonal pairs lift
    their feet by bending hip and knee), IMU and encoders from the true
    state, numpy noise at level 0 (rows 0-3) and 1 (rows 4-7)."""
    from quadruped_tpu.control.types import HybridCommand
    from quadruped_tpu.core import se3 as jse3
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.sim import whole_body as jwb

    params = ja1()
    model = jfb.build_model(params)
    cm = jwb.ContactModel()
    _, stance = _schedule(STREAM_TICKS)
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((STREAM_TICKS, B, 30)).astype(np.float32)
    noise *= np.repeat([0.0, 1.0], B // 2)[None, :, None]
    lift = np.tile([0.0, 0.35, -0.7], 4).astype(np.float32)

    def robot(h, stance, noise):
        sim0 = jwb.whole_body_init(params, body_height=h)

        def step(carry, x):
            sim, prev_v = carry
            st, n = x
            truth = jwb.observe(params, model, sim, cm)
            r = jse3.quat_to_rotmat(truth.base_quat)
            acc_world = (truth.base_vel_world - prev_v) / DT \
                + jnp.asarray([0.0, 0.0, 9.81])
            sensors = jcont.RawSensors(
                quat=truth.base_quat,
                acc_body=acc_world @ r + 0.3 * n[0:3],
                omega_body=truth.base_omega_body + 0.02 * n[3:6],
                joint_angles=truth.joint_angles + 0.002 * n[6:18],
                joint_velocities=truth.joint_velocities + 0.05 * n[18:30],
                foot_forces=truth.foot_forces)
            q = params.stand_angles + lift * (1.0 - jnp.repeat(st, 3))
            cmd = HybridCommand(q=q, kp=params.motor_kp, dq=jnp.zeros(12),
                                kd=params.motor_kd, tau=jnp.zeros(12))
            sim, _ = jwb.whole_body_step(params, model, sim, cmd, cm, DT)
            return (sim, truth.base_vel_world), sensors

        return jax.lax.scan(step, (sim0, jnp.zeros(3)), (stance, noise))[1]

    h0 = np.linspace(0.27, 0.28, B).astype(np.float32)
    sensors = jax.jit(jax.vmap(robot, in_axes=(0, 1, 1)))(h0, stance, noise)
    return jax.tree.map(lambda a: np.swapaxes(np.asarray(a), 0, 1), sensors)


def test_estimator_over_jax_whole_body_stream():
    """`estimator_update` over 200 ticks of the recorded stream (window 20
    / acc window 5): contact flags and refits equal to JAX's on every
    tick, the observation and the filters within TOL."""
    sensors = _jax_stream()
    phase, stance = _schedule(STREAM_TICKS)
    jcfg = jcont.EstimatorConfig(velocity=jvel.VelocityEstimatorConfig(
        window_size=20, acc_filter_window=5))
    params = ja1()

    def scan(sensors, phase, stance):
        def step(s, x):
            sens, ph, st = x
            s, obs = jax.vmap(lambda s, sens, ph, st: jcont.estimator_update(
                jcfg, params, s, sens, normalized_phase=ph,
                desired_stance=st, dt=DT))(s, sens, ph, st)
            return s, (s, obs)
        s0 = jax.vmap(lambda _: jcont.estimator_init(
            jcfg, params.body_height))(jnp.arange(B))
        return jax.lax.scan(step, s0, (sensors, phase, stance))[1]

    want_s, want_o = jax.jit(scan)(sensors, phase, stance)
    cfg = EstimatorConfig(velocity=velocity.VelocityEstimatorConfig(
        window_size=20, acc_filter_window=5))
    p = a1_params("cpu")
    s = estimator_init(cfg, B, p.body_height, "cpu")
    swings = 0
    for k in range(STREAM_TICKS):
        raw = RawSensors(**{f: tt(v[k]) for f, v in as_numpy(sensors).items()})
        s, obs = estimator_update(cfg, p, s, raw,
                                  normalized_phase=tt(phase[k]),
                                  desired_stance=tt(stance[k]), dt=DT)
        np.testing.assert_array_equal(s.contact.is_contact.numpy(),
                                      np.asarray(want_s.contact.is_contact[k]),
                                      err_msg=f"contact tick {k}")
        np.testing.assert_array_equal(s.contact.is_slip.numpy(),
                                      np.asarray(want_s.contact.is_slip[k]),
                                      err_msg=f"slip tick {k}")
        swings += int((s.contact.is_contact == 0).sum())
        assert _max(obs.base_position, want_o.base_position[k]) \
            <= TOL["stream_position"], k
        assert _max(obs.base_vel_world, want_o.base_vel_world[k]) \
            <= TOL["stream_velocity"], k
        assert _max(s.velocity.v_world, want_s.velocity.v_world[k]) \
            <= TOL["stream_velocity"], k
        assert _max(s.contact.p_contact, want_s.contact.p_contact[k]) \
            <= TOL["stream_p_contact"], k
        assert _max(s.ground.plane_coefs, want_s.ground.plane_coefs[k]) \
            <= TOL["stream_frame"], k
        assert _max(s.ground.ground_rot, want_s.ground.ground_rot[k]) \
            <= TOL["stream_frame"], k
    assert swings > 100, swings
    # The final state carried across from JAX is the port's own state.
    final = to_torch(jax.tree.map(lambda a: a[-1], want_s), EstimatorState,
                     device="cpu")
    assert torch.equal(final.contact.is_contact, s.contact.is_contact)
    assert torch.equal(final.velocity.vel_filter.count,
                       s.velocity.vel_filter.count)


def test_full_estimator_pipeline_runs_and_is_finite():
    """The port of test_full_estimator_pipeline_runs_and_is_finite."""
    p = a1_params("cpu")
    cfg = EstimatorConfig(velocity=velocity.VelocityEstimatorConfig(
        window_size=20, acc_filter_window=5))
    s = estimator_init(cfg, 1, device="cpu")
    sens = RawSensors(quat=se3.rpy_to_quat(tt([[0.01, -0.02, 0.1]])),
                      acc_body=tt([[0.1, 0.0, 9.8]]),
                      omega_body=tt([[0.0, 0.0, 0.1]]),
                      joint_angles=p.stand_angles[None].clone(),
                      joint_velocities=torch.zeros(1, 12),
                      foot_forces=torch.full((1, 4), 35.0))
    for _ in range(5):
        s, obs = estimator_update(cfg, p, s, sens,
                                  normalized_phase=torch.full((1, 4), 0.4),
                                  desired_stance=torch.ones(1, 4), dt=DT)
    leaves = [v for v in _leaves(as_numpy(s)) + _leaves(as_numpy(obs))]
    assert all(np.isfinite(v).all() for v in leaves)
    assert 0.2 < float(obs.base_position[0, 2]) < 0.35


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def test_velocity_estimator_converges_to_true_velocity():
    """The port of test_velocity_estimator_converges_to_true_velocity."""
    p = a1_params("cpu")
    cfg = velocity.VelocityEstimatorConfig(window_size=20,
                                           acc_filter_window=5)
    s = velocity.velocity_estimator_init(cfg, 1, "cpu")
    v_true = tt([0.4, -0.1, 0.0])
    q = p.stand_angles[None].clone()
    jac = kinematics.all_leg_jacobians(p, q)[0]
    dq = torch.linalg.solve(jac, (-v_true).expand(4, 3)[..., None])
    dq = dq[..., 0].reshape(1, 12)
    for _ in range(100):
        s = velocity.velocity_estimator_update(
            cfg, p, s, acc_body=tt([[0.0, 0.0, 9.81]]),
            quat=tt([[1.0, 0, 0, 0]]), omega_body=torch.zeros(1, 3),
            joint_angles=q, joint_velocities=dq,
            foot_contact=torch.ones(1, 4), dt=DT)
    np.testing.assert_allclose(s.v_world[0].numpy(), v_true.numpy(),
                               atol=0.02)


# --- the CMU filter ----------------------------------------------------------

def _cmu_stand(params):
    targets = torch.cat([params.hip_offset[:, :2], torch.zeros(4, 1)], -1) \
        + tt([0.0, 0.0, -0.27])
    return kinematics.joint_angles_from_foot_positions(params, targets)


def test_cmu_kf_matches_jax():
    """200 ticks of noisy stand readings at B=8, swing legs (low force) on
    some ticks, flat-ground and free-z variants: the state and covariance
    within TOL of JAX."""
    ticks = 200
    rng = np.random.default_rng(12)
    q0 = _cmu_stand(a1_params("cpu")).numpy()
    quat = _quats(rng, scale=0.02)
    r = se3.quat_to_rotmat(tt(quat)).numpy()
    ins = dict(
        acc_body=(np.einsum("bji,j->bi", r, [0.0, 0.0, 9.81])[None]
                  + rng.normal(0.0, 0.2, (ticks, B, 3))).astype(np.float32),
        quat=np.broadcast_to(quat, (ticks, B, 4)).copy(),
        omega_body=rng.normal(0.0, 0.05, (ticks, B, 3)).astype(np.float32),
        joint_angles=(q0[None, None] + rng.normal(0.0, 0.01, (ticks, B, 12))
                      ).astype(np.float32),
        joint_velocities=rng.normal(0.0, 0.2, (ticks, B, 12)).astype(
            np.float32),
        foot_force=np.where(rng.random((ticks, B, 4)) < 0.2, 0.0,
                            100.0).astype(np.float32))
    for flat in (True, False):
        jcfg = jcmu.CmuKfConfig(assume_flat_ground=flat)

        def scan(ins, jcfg=jcfg):
            def step(s, x):
                s = jax.vmap(lambda s, x: jcmu.cmu_kf_update(
                    jcfg, ja1(), s, dt=DT, **x))(s, x)
                return s, s
            s0 = jax.vmap(lambda q, j: jcmu.cmu_kf_init(
                ja1(), quat=q, joint_angles=j, base_height=0.3))(
                    ins["quat"][0], ins["joint_angles"][0])
            return s0, jax.lax.scan(step, s0, ins)[1]

        s0, want = jax.jit(scan)(ins)
        p = a1_params("cpu")
        s = cmu_kf.cmu_kf_init(p, quat=tt(ins["quat"][0]),
                               joint_angles=tt(ins["joint_angles"][0]),
                               base_height=0.3)
        assert _max(s.x, s0.x) <= 1e-6
        cfg = cmu_kf.CmuKfConfig(assume_flat_ground=flat)
        for k in range(ticks):
            s = cmu_kf.cmu_kf_update(cfg, p, s, dt=DT,
                                     **{n: tt(v[k]) for n, v in ins.items()})
            assert _max(s.x, want.x[k]) <= TOL["cmu_x"], (flat, k)
            assert _max(s.cov, want.cov[k]) <= TOL["cmu_cov"], (flat, k)


def _cmu_static(params, quat):
    r = se3.quat_to_rotmat(quat)
    return dict(acc_body=torch.einsum("bji,j->bi", r, tt([0.0, 0.0, 9.81])),
                quat=quat, omega_body=torch.zeros(1, 3),
                joint_angles=_cmu_stand(params)[None],
                joint_velocities=torch.zeros(1, 12),
                foot_force=torch.full((1, 4), 100.0))


def test_cmu_static_convergence():
    """The port of test_static_convergence."""
    p = a1_params("cpu")
    quat = tt([[1.0, 0.0, 0.0, 0.0]])
    sens = _cmu_static(p, quat)
    s = cmu_kf.cmu_kf_init(p, quat=quat, joint_angles=sens["joint_angles"],
                           base_height=0.31)
    for _ in range(800):
        s = cmu_kf.cmu_kf_update(cmu_kf.CmuKfConfig(), p, s, dt=DT, **sens)
    v, pos = cmu_kf.base_velocity_world(s), cmu_kf.base_position(s)
    feet = cmu_kf.foot_positions_world(s)
    assert float(v.abs().max()) < 0.01
    assert abs(float(pos[0, 2]) - 0.27) < 0.02
    assert float(feet[..., 2].abs().max()) < 0.01
    fk = kinematics.foot_positions_in_base_frame(p, sens["joint_angles"])
    assert float(((feet - pos[:, None]) - fk).abs().max()) < 0.01


def test_cmu_tracks_constant_velocity():
    """The port of test_tracks_constant_velocity."""
    p = a1_params("cpu")
    quat = tt([[1.0, 0.0, 0.0, 0.0]])
    v_true = tt([0.4, 0.0, 0.0])
    q = _cmu_stand(p)[None]
    jac = kinematics.all_leg_jacobians(p, q)[0]
    dq = torch.linalg.solve(jac, (-v_true).expand(4, 3)[..., None])
    sens = dict(acc_body=tt([[0.0, 0.0, 9.81]]), quat=quat,
                omega_body=torch.zeros(1, 3), joint_angles=q,
                joint_velocities=dq[..., 0].reshape(1, 12),
                foot_force=torch.full((1, 4), 100.0))
    s = cmu_kf.cmu_kf_init(p, quat=quat, joint_angles=q)
    for _ in range(600):
        s = cmu_kf.cmu_kf_update(cmu_kf.CmuKfConfig(), p, s, dt=DT, **sens)
    assert float((cmu_kf.base_velocity_world(s) - v_true).abs().max()) < 0.03


def test_cmu_swing_legs_do_not_corrupt():
    """The port of test_swing_legs_do_not_corrupt."""
    p = a1_params("cpu")
    quat = tt([[1.0, 0.0, 0.0, 0.0]])
    base = _cmu_static(p, quat)
    s = cmu_kf.cmu_kf_init(p, quat=quat, joint_angles=base["joint_angles"])
    cfg = cmu_kf.CmuKfConfig()
    for _ in range(400):
        s = cmu_kf.cmu_kf_update(cfg, p, s, dt=DT, **base)
    v_ref = cmu_kf.base_velocity_world(s).clone()
    swing = dict(base)
    swing["joint_velocities"] = base["joint_velocities"].clone()
    swing["joint_velocities"][0, 0:3] = 5.0
    swing["foot_force"] = base["foot_force"].clone()
    swing["foot_force"][0, 0] = 0.0
    for _ in range(200):
        s = cmu_kf.cmu_kf_update(cfg, p, s, dt=DT, **swing)
    assert float((cmu_kf.base_velocity_world(s) - v_ref).abs().max()) < 0.02


def test_cmu_covariance_symmetric_and_batched():
    """The port of test_covariance_symmetric_and_batched: a batch of five
    IMU readings updates as five single updates."""
    p = a1_params("cpu")
    quat = tt([[1.0, 0.0, 0.0, 0.0]])
    sens = _cmu_static(p, quat)
    s = cmu_kf.cmu_kf_init(p, quat=quat, joint_angles=sens["joint_angles"])
    cfg = cmu_kf.CmuKfConfig()
    s1 = cmu_kf.cmu_kf_update(cfg, p, s, dt=DT, **sens)
    assert float((s1.cov - s1.cov.transpose(-1, -2)).abs().max()) < 1e-6
    assert float(torch.linalg.eigvalsh(s1.cov).min()) > -1e-5
    rng = np.random.default_rng(0)
    accs = tt(rng.normal(size=(5, 3)) * 0.1 + np.array([0, 0, 9.81]))
    five = cmu_kf.CmuKfState(x=s.x.expand(5, -1), cov=s.cov.expand(5, -1, -1))
    batched = cmu_kf.cmu_kf_update(
        cfg, p, five, dt=DT,
        **{k: (accs if k == "acc_body" else v.expand((5,) + v.shape[1:]))
           for k, v in sens.items()}).x
    single = torch.cat([cmu_kf.cmu_kf_update(cfg, p, s, dt=DT, **dict(
        sens, acc_body=a[None])).x for a in accs])
    np.testing.assert_allclose(batched.numpy(), single.numpy(), atol=1e-6)
