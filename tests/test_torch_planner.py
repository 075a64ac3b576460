"""The walk's planners against the JAX package (CPU): the pose planner
(centroid heuristic, the support-polygon SQP, the latch and the
intermediate pose) and the foot stepper (gap offsets, stair snapping,
the step-sequence lookahead, the stair and gap foothold hooks).

The SQP runs on B=64 random support configurations (3 and 4 contacts,
flat ground and slopes of up to +-0.1 rad, one concave quad) against
`jax.vmap` of the JAX function, and both against a float64 run of the
port. CPU readings: port vs JAX 9e-8, port vs float64 8e-8, JAX vs
float64 9e-8 (max over the 6 pose coordinates); limit SQP_TOL = 1e-6. The
foot-stepper functions are exact selections and comparisons: they must
agree within 1e-6 m (the candidate grid's float32 values differ from
jnp.linspace's by ~1e-9 m), and their tests mirror tests/test_planner.py
and tests/test_gap_crossing.py on the port.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.planner import foot_stepper as fs
from quadruped_tpu_torch.planner import pose_planner as pp
from quadruped_tpu_torch.robots import a1_params

# Small batches: one intra-op thread a process. torch would otherwise
# spread each op over every core, and the tier-1 run's six workers
# would oversubscribe the CPU (a whole-body test file: 55 s with the
# default threads alone, 35 s with one).
torch.set_num_threads(1)

SQP_TOL = 1e-6
STEP_TOL = 1e-6
FEET = np.array([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                 [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]], np.float32)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _params64():
    p = a1_params("cpu")
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).double() for f in dataclasses.fields(p)
        if torch.is_tensor(getattr(p, f.name))
        and getattr(p, f.name).is_floating_point()})


def _support_configs(batch=64, seed=0):
    """Random stance configurations: feet jittered around the stand
    footprint on a slope of up to +-0.1 rad, 3 or 4 contacts, one concave
    quad (scenario 0)."""
    rng = np.random.default_rng(seed)
    feet = FEET[None] + rng.normal(0.0, 0.02, (batch, 4, 3))
    slope = rng.uniform(-0.1, 0.1, batch)
    slope[: batch // 4] = 0.0
    feet[..., 2] -= feet[..., 0] * np.tan(slope)[:, None]
    feet[0, 3, :2] = (0.05, -0.02)
    base = np.stack([rng.normal(0, 0.02, batch), rng.normal(0, 0.02, batch),
                     0.27 + rng.normal(0, 0.01, batch)], -1)
    rpy = rng.normal(0.0, 0.03, (batch, 3))
    support = np.ones((batch, 4))
    drop = rng.integers(0, 5, batch)
    for i in range(batch):
        if drop[i] < 4:
            support[i, drop[i]] = 0.0
    support[0] = 1.0
    ground = np.stack([np.zeros(batch), slope, np.zeros(batch)], -1)
    return tuple(np.asarray(a, np.float32)
                 for a in (base, rpy, feet, support, ground))


def _jax_sqp(args, body_height):
    import jax

    from quadruped_tpu.planner import pose_planner as jpp
    from quadruped_tpu.robots import a1_params as ja1

    return np.asarray(jax.jit(jax.vmap(
        lambda b, r, f, s, g: jpp.plan_target_pose_sqp(
            ja1(), b, r, f, s, g, body_height)))(*args))


def test_concave_quad_drops_a_vertex():
    base, rpy, feet, support, ground = _support_configs()
    ccw = feet[:, pp.CCW_ORDER]
    valid = pp._drop_concave_vertex(T(ccw[..., :2]),
                                    T(support[:, pp.CCW_ORDER]))
    assert valid[0].sum() == 3.0
    assert (valid[1:].sum(-1) == T(support[1:]).sum(-1)).all()


def test_sqp_matches_jax_and_float64():
    args = _support_configs()
    want = _jax_sqp(args, np.float32(0.27))
    got = pp.plan_target_pose_sqp(a1_params("cpu"), *map(T, args),
                                  0.27).numpy()
    ref = pp.plan_target_pose_sqp(
        _params64(), *(T(a, torch.float64) for a in args), 0.27).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SQP_TOL
    assert np.abs(got - ref).max() <= SQP_TOL
    assert np.abs(want - ref).max() <= SQP_TOL


def _sqp(feet, support, ground=(0.0, 0.0, 0.0)):
    return pp.plan_target_pose_sqp(
        a1_params("cpu"), T([[0.0, 0.0, 0.27]]), T([[0.0, 0.0, 0.0]]),
        T(feet[None]), T([support]), T([ground]), 0.27)[0].numpy()


def test_sqp_flat_symmetric():
    np.testing.assert_allclose(_sqp(FEET, [1.0] * 4),
                               [0, 0, 0.27, 0, 0, 0], atol=2e-3)


def test_sqp_three_contact_constrained():
    p = _sqp(FEET, [0.0, 1.0, 1.0, 1.0])
    assert p[0] < -0.015 and p[1] > 0.012, p
    assert p[0] > -0.052 and p[1] < 0.045, p
    assert np.abs(p[3:6]).max() < 0.02, p
    assert abs(p[2] - 0.27) < 0.01
    r = se3.rpy_to_rotmat(T(p[3:6])).numpy()
    hips = a1_params("cpu").hip_offset.numpy()
    lens = np.linalg.norm(p[None, :3] + hips @ r.T - FEET, axis=-1)[[1, 2, 3]]
    assert (lens > 0.21).all() and (lens < 0.36).all(), lens


def test_sqp_slope_alignment():
    s = math.tan(math.radians(10))
    feet = FEET.copy()
    feet[:, 2] -= feet[:, 0] * s
    p = _sqp(feet, [1.0] * 4, (0.0, math.radians(10), 0.0))
    assert abs(p[4] - math.radians(10)) < 0.02, p
    assert abs(p[2] - 0.27) < 0.02, p


def _update_args(batch):
    """The base 5 cm behind the stance centroid, yawed 0.2 rad."""
    rng = np.random.default_rng(1)
    feet = FEET[None] + np.asarray([0.5, 0.0, 0.0], np.float32) \
        + rng.normal(0, 0.01, (batch, 4, 3)).astype(np.float32)
    return dict(base_position=np.tile([0.45, 0.0, 0.27], (batch, 1)),
                base_rpy=np.tile([0.0, 0.0, 0.2], (batch, 1)),
                foot_positions_world=feet,
                support_mask=np.ones((batch, 4)),
                ground_rpy=np.zeros((batch, 3)),
                body_height=np.full(batch, 0.27))


@pytest.mark.parametrize("use_sqp", [False, True])
def test_pose_planner_update_matches_jax(use_sqp):
    """The latch (replan in half the scenarios, none planned before) and
    the intermediate pose at phases 0, 0.5, 1, against jax.vmap."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.planner import pose_planner as jpp
    from quadruped_tpu.robots import a1_params as ja1

    b = 4
    args = {k: np.asarray(v, np.float32) for k, v in _update_args(b).items()}
    replan = np.asarray([1, 0, 1, 0], np.float32)
    planned = np.asarray([0, 1, 1, 1], np.float32)
    start = np.random.default_rng(2).normal(0, 0.1, (b, 6)).astype(np.float32)
    target = start + 0.05

    def jax_one(st, tg, pl, rp, kw):
        state = jpp.PosePlannerState(pose_start=st, pose_target=tg,
                                     planned=pl)
        new = jpp.pose_planner_update(state, ja1(), replan=rp,
                                      use_sqp=use_sqp, **kw)
        mids = [jpp.intermediate_base_pose(new, jnp.asarray(x))[0]
                for x in (0.0, 0.5, 1.0)]
        return new.pose_start, new.pose_target, jnp.stack(mids)

    want = [np.asarray(a) for a in jax.vmap(jax_one)(
        start, target, planned, replan, args)]
    state = pp.PosePlannerState(pose_start=T(start), pose_target=T(target),
                                planned=T(planned))
    new = pp.pose_planner_update(state, a1_params("cpu"), replan=T(replan),
                                 use_sqp=use_sqp,
                                 **{k: T(v) for k, v in args.items()})
    mids = torch.stack([pp.intermediate_base_pose(
        new, torch.full((b,), x))[0] for x in (0.0, 0.5, 1.0)], 1)
    for got, ref in zip((new.pose_start, new.pose_target, mids), want):
        assert np.abs(got.numpy() - ref).max() <= SQP_TOL
    assert (new.planned == 1.0).all()
    # Unlatched scenario 1 keeps its plan.
    np.testing.assert_array_equal(new.pose_target[1].numpy(), target[1])
    if not use_sqp:
        # The centroid heuristic: the CoM over the support centroid, yaw
        # kept.
        com_x = a1_params("cpu").com_offset[0].item()
        centroid_x = args["foot_positions_world"][0, :, 0].mean()
        assert abs(new.pose_target[0, 0].item() - centroid_x - com_x) < 1e-5
        assert abs(new.pose_target[0, 5].item() - 0.2) < 1e-6


def test_sqp_runs_only_when_a_scenario_latches(monkeypatch):
    calls = []
    sqp = pp.plan_target_pose_sqp
    monkeypatch.setattr(pp, "plan_target_pose_sqp",
                        lambda *a, **k: calls.append(1) or sqp(*a, **k))
    b = 2
    args = {k: T(np.asarray(v, np.float32))
            for k, v in _update_args(b).items()}
    state = pp.pose_planner_init(b, "cpu")
    state = pp.pose_planner_update(state, a1_params("cpu"),
                                   replan=torch.zeros(b), **args)
    state = pp.pose_planner_update(state, a1_params("cpu"),
                                   replan=torch.zeros(b), **args)
    assert len(calls) == 1


# --- foot stepper ---

def _jfs():
    from quadruped_tpu.planner import foot_stepper as jfs

    return jfs


def test_gaps_avoided_like_jax():
    import jax.numpy as jnp

    jfs = _jfs()
    centers = np.asarray([0.5], np.float32)
    feet = np.asarray([[[0.5, -0.13, 0.0], [0.52, 0.13, 0.0],
                        [0.15, -0.13, 0.0], [0.15, 0.13, 0.0]],
                       [[0.5, -0.13, 0.0], [0.5, 0.13, 0.0],
                        [0.15, -0.13, 0.0], [0.15, 0.13, 0.0]]], np.float32)
    widths = (0.12, 0.1)
    for i, width in enumerate(widths):
        got = fs.adjust_footholds_for_gaps(T(feet[i:i + 1]), T(centers),
                                           width)[0].numpy()
        want = np.asarray(jfs.adjust_footholds_for_gaps(
            jnp.asarray(feet[i]), jnp.asarray(centers), width))
        assert np.abs(got - want).max() <= STEP_TOL
        assert not fs.gap_infeasible(T(got[:, 0]), T(centers), width).any()
        np.testing.assert_allclose(got[:, 0] - feet[i, :, 0],
                                   got[0, 0] - feet[i, 0, 0], atol=1e-6)
    # Feasible nominals stay put.
    far = fs.adjust_footholds_for_gaps(T(feet[1:]), T([5.0]), 0.1)
    np.testing.assert_allclose(far.numpy(), feet[1:], atol=1e-6)


def test_stairs_snap_like_jax():
    jfs = _jfs()
    feet = np.asarray([[0.8, -0.13, 0.0], [0.8, 0.13, 0.0],
                       [0.3, -0.13, 0.0], [0.74, 0.13, 0.0]], np.float32)
    got = fs.snap_to_stairs(T(feet[None]), 0.25, 0.06, 0.5)[0].numpy()
    want = np.asarray(jfs.snap_to_stairs(feet, step_length=0.25,
                                         step_height=0.06, start_x=0.5))
    assert np.abs(got - want).max() <= STEP_TOL
    np.testing.assert_allclose(got[0, 2], 0.06, atol=1e-6)
    np.testing.assert_allclose(got[2, 2], 0.0, atol=1e-6)


def test_plan_step_sequence_like_jax():
    jfs = _jfs()
    cases = [(np.asarray([0.35, 0.35, 0.0, 0.0]), np.asarray([0.52, 0.83]),
              6),
             (np.asarray([0.0, 0.0, -0.35, -0.35]),
              np.arange(0.06, 1.2, 0.12), 4)]
    for x0, gaps, n in cases:
        x0, gaps = x0.astype(np.float32), gaps.astype(np.float32)
        off, xs = fs.plan_step_sequence(T(x0[None]), T(gaps), 0.08,
                                        n_steps=n)
        j_off, j_xs = jfs.plan_step_sequence(x0, gaps, 0.08, n_steps=n)
        assert np.abs(off[0].numpy() - np.asarray(j_off)).max() <= STEP_TOL
        assert np.abs(xs[0].numpy() - np.asarray(j_xs)).max() <= STEP_TOL
    # The first case clears every gap and keeps moving; the second takes
    # the cross-gait half step.
    off, xs = fs.plan_step_sequence(T(cases[0][0][None]), T(cases[0][1]),
                                    0.08, n_steps=6)
    assert not fs.gap_infeasible(xs, T(cases[0][1]), 0.08).any()
    assert (off > 0).all() and float(xs[0, -1, 0] - 0.35) > 0.35
    off, _ = fs.plan_step_sequence(T(cases[1][0][None]), T(cases[1][1]),
                                   0.08, n_steps=4)
    assert np.isclose(off[0].numpy(), [0.05, 0.1, 0.1, 0.05]).all(1).any()


def test_stair_coordination_like_jax():
    import jax.numpy as jnp

    jfs = _jfs()
    jstair = jfs.StairParams(start_x=jnp.asarray(1.0),
                             width=jnp.asarray(0.2),
                             height=jnp.asarray(0.1), count=jnp.asarray(3))
    stair = fs.StairParams(T(1.0), T(0.2), T(0.1), torch.as_tensor(3))
    xs = np.asarray([[0.94, 0.94, 0.80, 0.80], [1.34, 1.05, 0.80, 0.80],
                     [1.18, 1.2, 1.1, 0.97], [1.7, 1.72, 1.5, 1.62]],
                    np.float32)
    x_adj, dz = fs.stair_foothold_adjust(T(xs), stair, 0.1)
    for i in range(len(xs)):
        jx, jdz = jfs.stair_foothold_adjust(xs[i], jstair, 0.1)
        assert np.abs(x_adj[i].numpy() - np.asarray(jx)).max() <= STEP_TOL
        assert np.abs(dz[i].numpy() - np.asarray(jdz)).max() <= STEP_TOL
    assert dz[0, 0] > 0.05 and dz[0, 1] > 0.05 and x_adj[0, 0] > 1.0
    assert dz[0, 2] == 0.0 and dz[0, 3] == 0.0
    assert dz[1, 0] == 0.0 and x_adj[1, 0] < 1.4
    # Per-scenario stairs: a [B] start_x picks each scenario's riser.
    per = fs.StairParams(T([1.0, 1.0, 1.0, 1.0]), T(0.2), T(0.1),
                         torch.as_tensor(3))
    x_per, dz_per = fs.stair_foothold_adjust(T(xs), per, 0.1)
    assert torch.equal(x_per, x_adj) and torch.equal(dz_per, dz)


def test_gap_foothold_adjust_like_jax():
    jfs = _jfs()
    gap_x, gap_w = 0.25, 0.06
    x = np.asarray([[gap_x - 0.04, gap_x + 0.04, gap_x - 0.2, gap_x + 0.2],
                    [0.24, 0.26, 0.1, 0.3]], np.float32)
    current = np.asarray([[0.1, 0.1, -0.1, -0.1], [0.1, 0.31, -0.1, 0.3]],
                         np.float32)
    for margin, cur in ((0.03, None), (0.02, current)):
        got = fs.gap_foothold_adjust(T(x), T([gap_x]), gap_w, margin=margin,
                                     current_x=None if cur is None
                                     else T(cur)).numpy()
        for i in range(len(x)):
            want = np.asarray(jfs.gap_foothold_adjust(
                x[i], np.asarray([gap_x], np.float32), gap_w, margin=margin,
                current_x=None if cur is None else cur[i]))
            assert np.abs(got[i] - want).max() <= STEP_TOL
    out = fs.gap_foothold_adjust(T(x[:1]), T([gap_x]), gap_w)[0].numpy()
    half = gap_w / 2 + 0.03
    np.testing.assert_allclose(out[0], gap_x - half, atol=1e-6)
    np.testing.assert_allclose(out[1], gap_x + half, atol=1e-6)
    np.testing.assert_allclose(out[2:], x[0, 2:], atol=1e-6)
    assert not fs.gap_infeasible(T(out[None]), T([gap_x]), gap_w).any()
