"""Move blocking, the long-horizon configuration and the flip-aware warm start
of the port against the JAX package.

Same inputs, drawn with numpy from a seed, go to both packages; JAX's
per-scenario functions are `jax.vmap`-ed over the scenario axis. The
condensation and warm-start functions are exact rearrangements, held to
float32 roundoff; the MPC solves carry the Newton-Schulz rounding
differences of tests/test_torch_cone_qp.py and are held to their tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import mpc as j_mpc
from quadruped_tpu.control.desired_state import DesiredStateCommand as JDes
from quadruped_tpu.control.types import RobotObservation as JObs
from quadruped_tpu.core import se3 as j_se3
from quadruped_tpu.gait import ADVANCED_TROT as JAT
from quadruped_tpu.gait import scheduler as j_sched
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.solvers import condense as j_condense
from quadruped_tpu.solvers import cone_qp as j_cone
from quadruped_tpu_torch.control import mpc as t_mpc
from quadruped_tpu_torch.control.desired_state import DesiredStateCommand
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import GaitState
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.solvers import condense as t_condense
from quadruped_tpu_torch.solvers import cone_qp as t_cone
from quadruped_tpu_torch.utils.convert import as_numpy, to_torch

B = 4
MG = 13.0 * 9.81


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


BLOCKINGS = [(10, 6, 2), (16, 4, 2), (16, 4, 3), (5, 2, 2), (8, 8, 2)]


@pytest.mark.parametrize("horizon,head,block", BLOCKINGS,
                         ids=[f"h{h}_{a}_{b}" for h, a, b in BLOCKINGS])
def test_reduce_and_expand_match_jax(horizon, head, block):
    """Groups exactly; E^T P E, E^T q and the min-over-group fz_hi to
    float32 roundoff of the [H, G] contractions; the expansion exactly."""
    groups, n_g = t_condense.move_block_groups(horizon, head, block)
    j_groups, j_ng = j_condense.move_block_groups(horizon, head, block)
    assert n_g == j_ng and np.array_equal(groups, j_groups)

    rng = np.random.default_rng(horizon * 100 + head * 10 + block)
    n = 12 * horizon
    a = rng.normal(size=(B, n, n)).astype(np.float32)
    p = (a + a.transpose(0, 2, 1)).astype(np.float32)
    q = rng.normal(size=(B, n)).astype(np.float32)
    fz = (rng.uniform(size=(B, 4 * horizon)) > 0.4).astype(np.float32) * 127.5
    got = t_condense.reduce_move_blocking(tt(p), tt(q), tt(fz), groups, n_g,
                                          horizon)
    want = j_condense.reduce_move_blocking(p, q, fz, groups, n_g, horizon)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    u = rng.normal(size=(B, 12 * n_g)).astype(np.float32)
    np.testing.assert_array_equal(
        t_condense.expand_move_blocking(tt(u), groups, horizon).numpy(),
        np.asarray(j_condense.expand_move_blocking(u, groups, horizon)))


def test_long_horizon_config_matches_jax():
    """Every scalar field, the state weights and n_force_groups."""
    jc = j_mpc.long_horizon_config()
    tc = t_mpc.long_horizon_config()
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        if f.name == "state_weights":
            np.testing.assert_array_equal(np.asarray(tc.state_weights,
                                                     np.float32),
                                          np.asarray(want))
        else:
            assert getattr(tc, f.name) == want, f.name
    assert tc.n_force_groups == jc.n_force_groups == 10
    assert t_mpc.MpcConfig(horizon=10, move_block=(6, 2)).n_force_groups == 8


def test_shift_warm_start_matches_jax():
    """Selection and shift exactly, on pin patterns where the shifted start
    is taken (a one-step advance, a full flip) and where it is not (no
    flip, three flipped triples)."""
    h, legs = 10, 4
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 12 * h)).astype(np.float32)
    y = rng.normal(size=(B, 4 * h, 5)).astype(np.float32)
    steps = (np.arange(h)[:, None] + np.arange(legs)[None, :]) % 3 == 0
    pin_prev = np.broadcast_to(steps.reshape(-1), (B, 4 * h)).astype(
        np.float32).copy()
    pin_new = pin_prev.copy()
    pin_new[0] = np.concatenate([steps[1:], steps[-1:]]).reshape(-1)
    pin_new[1] = 1.0 - pin_prev[1]
    pin_new[2, :3] = 1.0 - pin_new[2, :3]
    got = t_cone.shift_warm_start(tt(x), tt(y), tt(pin_prev), tt(pin_new))
    want = jax.vmap(j_cone.shift_warm_start)(x, y, pin_prev, pin_new)
    shifted = [not np.array_equal(np.asarray(want[0])[i], x[i])
               for i in range(B)]
    assert shifted == [True, True, False, False]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the blocked MPC solve and cold start -----------------------------------

def _inputs(horizon, times):
    """JAX (obs, des, gait state, contact table) for B scenarios of a
    trotting A1 near its nominal stance, the gait clocks at `times`."""
    rng = np.random.default_rng(21)
    rpy = (rng.normal(size=(B, 3)) * 0.05).astype(np.float32)
    quat = np.asarray(jax.vmap(j_se3.rpy_to_quat)(rpy))
    joints = (np.tile([0.0, 0.67, -1.25], 4)
              + rng.normal(size=(B, 12)) * 0.05).astype(np.float32)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    obs = JObs(
        base_position=f32(np.c_[rng.normal(size=(B, 2)) * 0.05,
                                0.27 + rng.normal(size=B) * 0.01]),
        base_rpy=f32(rpy), base_quat=f32(quat),
        base_vel_world=f32(rng.normal(size=(B, 3)) * 0.1),
        base_omega_world=f32(rng.normal(size=(B, 3)) * 0.1),
        base_omega_body=f32(rng.normal(size=(B, 3)) * 0.1),
        joint_angles=f32(joints), joint_velocities=f32(np.zeros((B, 12))),
        foot_contact=f32(np.ones((B, 4))), foot_forces=f32(np.zeros((B, 4))))
    z3 = np.zeros((B, 3), np.float32)
    des = JDes(position=f32(np.tile([0.0, 0.0, 0.27], (B, 1))), rpy=f32(z3),
               velocity=f32(np.c_[rng.uniform(0.2, 0.6, B), np.zeros((B, 2))]),
               omega=f32(np.c_[np.zeros((B, 2)), rng.normal(size=B) * 0.2]),
               filtered_linear=f32(z3), filtered_wz=f32(np.zeros(B)))
    gait = jax.vmap(lambda t: j_sched.gait_update(
        JAT(), j_sched.gait_init(JAT()), t, jnp.ones(4)))(f32(times))
    table = jax.vmap(lambda g: j_sched.predicted_contact_table(
        JAT(), g, 0.03, horizon))(gait)
    return obs, des, gait, table


# Gait clocks of the solve; the cold start runs one MPC step (30 ms)
# earlier, so the contact table advances a row between the two.
TIMES = np.random.default_rng(5).uniform(0.1, 0.5, B).astype(np.float32)

CONFIGS = {
    "h10_block_6_2": dict(horizon=10, move_block=(6, 2)),
    "h16_long": None,
    "h10_warm_shift": dict(horizon=10, qp_warm_shift=True),
}


@functools.lru_cache(maxsize=None)
def _cold_start(name):
    """(JAX config, port config, JAX cold-start state) at TIMES - 30 ms."""
    kw = CONFIGS[name]
    if kw is None:
        jcfg, tcfg = j_mpc.long_horizon_config(), t_mpc.long_horizon_config()
    else:
        jcfg, tcfg = j_mpc.MpcConfig(**kw), t_mpc.MpcConfig(**kw)
    obs, des, gait, _ = _inputs(jcfg.horizon, TIMES - 0.03)
    params = j_a1()
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                      j_mpc.mpc_init(jcfg))
    cold = jax.jit(jax.vmap(lambda g, s, o, d: j_mpc.mpc_cold_start(
        jcfg, params, JAT(), g, s, o, d)))(gait, js, obs, des)
    return jcfg, tcfg, cold


def _port(obs, des, gait):
    return (to_torch(obs, RobotObservation),
            to_torch(des, DesiredStateCommand), to_torch(gait, GaitState))


def _compare_state(got, want):
    g, w = as_numpy(got), as_numpy(want)
    for key in ("forces_world", "warm_primal"):
        np.testing.assert_allclose(g.pop(key), w.pop(key), atol=0.01 * MG,
                                   err_msg=key)
    dual_scale = float(np.max(np.abs(w["warm_dual"])))
    np.testing.assert_allclose(g.pop("warm_dual"), w.pop("warm_dual"),
                               atol=0.01 * dual_scale)
    np.testing.assert_array_equal(g.pop("warm_pinned"), w.pop("warm_pinned"))
    for key, value in w.items():
        np.testing.assert_allclose(g[key], value, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["h10_block_6_2", "h16_long"])
def test_mpc_cold_start_matches_jax(name):
    """The 400-iteration relaxed boot solve from the per-group gravity
    table, in the blocked space: forces, warm primal and duals within 1%
    (m*g, dual scale), the rest to float32 roundoff."""
    jcfg, tcfg, want = _cold_start(name)
    obs, des, gait, _ = _inputs(jcfg.horizon, TIMES - 0.03)
    tobs, tdes, tgait = _port(obs, des, gait)
    got = t_mpc.mpc_cold_start(tcfg, a1_params("cpu"), ADVANCED_TROT("cpu"),
                               tgait,
                               t_mpc.mpc_init(tcfg, B), tobs, tdes)
    assert got.warm_primal.shape == (B, 12 * tcfg.n_force_groups)
    _compare_state(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mpc_solve_matches_jax(name):
    """The warm 24-iteration Fast-ADMM solve one MPC step after the JAX
    cold start, both packages from that same state. Forces and warm primal
    within 1% m*g, duals within 1% of their scale (the Newton-Schulz
    rounding differences of test_torch_cone_qp.py, amplified by ADMM), the
    pin pattern exactly. In the warm-shift case the shifted start is taken
    for at least one scenario (checked)."""
    jcfg, tcfg, js = _cold_start(name)
    obs, des, gait, table = _inputs(jcfg.horizon, TIMES)
    if jcfg.qp_warm_shift:
        pin_new = (np.asarray(table) < 0.5).reshape(B, -1)
        x0, _ = jax.vmap(j_cone.shift_warm_start)(
            js.warm_primal, js.warm_dual, js.warm_pinned, pin_new)
        assert np.sum(np.any(np.asarray(x0) != np.asarray(js.warm_primal),
                             axis=-1)) >= 1
    params = j_a1()
    rpy_comp = jnp.zeros((B, 2), jnp.float32)
    height = jnp.full((B,), 0.27, jnp.float32)
    want = jax.jit(jax.vmap(lambda s, o, d, c, r, h: j_mpc.mpc_solve(
        jcfg, params, s, o, d, c, r, h)))(js, obs, des, table, rpy_comp,
                                          height)
    tobs, tdes, _ = _port(obs, des, gait)
    got = t_mpc.mpc_solve(tcfg, a1_params("cpu"), to_torch(js, t_mpc.MpcState),
                          tobs, tdes, tt(table), tt(rpy_comp), tt(height))
    _compare_state(got, want)
