"""The port's dense condensation path (quadruped_tpu_torch/solvers/condense.py)
against the JAX package, on the CPU, and the twin of
tests/test_warm_start_cadence.py on the port.

`horizon_powers`, `condense_dynamics`, `cone_constraint_pattern`,
`build_cone_constraints`, `condense_cost` and `condense_qp` take the same
numpy-seeded SRB models (B=4, H=5 and H=10) in both packages. Tolerances:
the cone rows and bounds exactly (they are copies and products by 1 or
mu); the powers, Toeplitz blocks, P and q to 1e-5 relative (float32 sums
in another order) with an absolute floor at the size of each quantity's
float32 roundoff (P ~ 1e1, q ~ 1e3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.core import se3 as j_se3
from quadruped_tpu.dynamics import srb as j_srb
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.solvers import condense as j_condense
from quadruped_tpu_torch.control.mpc import MpcConfig
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import srb
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.solvers import condense, cone_qp
from test_warm_start_cadence import problem_at as jax_problem_at

torch.set_num_threads(1)

B = 4
W = (10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0)


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def _model(horizon, seed):
    """(ad, bd, a_ct, x0, x_des) of B random SRB states, as numpy, built
    by the JAX package (the port's SRB model is held to it in
    tests/test_torch_modules.py)."""
    rng = np.random.default_rng(seed)
    rpy = jnp.asarray(rng.normal(size=(B, 3)) * 0.1, jnp.float32)
    feet = jnp.asarray(
        rng.normal(size=(B, 4, 3)) * 0.05
        + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                    [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]),
        jnp.float32)
    x0 = np.concatenate([rng.normal(size=(B, 12)) * 0.05,
                         j_srb.GRAVITY * np.ones((B, 1))], 1)
    x_des = rng.normal(size=(B, horizon, 13)) * 0.2
    params = j_a1()
    a_ct, b_ct = j_srb.srb_continuous(j_se3.rpy_to_rotmat(rpy),
                                      params.total_inertia,
                                      params.total_mass, feet)
    ad, bd = j_srb.srb_discretize(a_ct, b_ct, 0.03)
    return tuple(np.asarray(v, np.float32)
                 for v in (ad, bd, a_ct, x0, x_des))


def _contact(horizon, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, horizon, 4)) < 0.6).astype(np.float32)


def _close(got, want, **tol):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("horizon", [5, 10])
def test_dynamics_matches_jax(horizon):
    """Ad^(k+1) and the Toeplitz Bqp: 1e-5 relative, 1e-6 absolute."""
    ad, bd, *_ = _model(horizon, 0)
    _close(condense.horizon_powers(tt(ad), horizon),
           j_condense.horizon_powers(ad, horizon), rtol=1e-5, atol=1e-6)
    aqp, bqp = condense.condense_dynamics(tt(ad), tt(bd), horizon)
    jaqp, jbqp = j_condense.condense_dynamics(ad, bd, horizon)
    _close(aqp, jaqp, rtol=1e-5, atol=1e-6)
    _close(bqp, jbqp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("horizon", [5, 10])
def test_cone_constraints_match_jax(horizon):
    """The pattern, the dense cone matrix and its bounds, exactly; mu per
    scenario and one shared; swing rows capped at 0."""
    _close(condense.cone_constraint_pattern(device="cpu"),
           j_condense.cone_constraint_pattern(), rtol=0, atol=0)
    contact = _contact(horizon, 1)
    mu = np.array([0.3, 0.45, 0.6, 0.45], np.float32)
    fmax = np.array([120.0, 130.0, 140.0, 150.0], np.float32)
    for m in (mu, np.float32(0.45)):
        a, l, u = condense.build_cone_constraints(tt(m), tt(fmax),
                                                  tt(contact), horizon)
        ja, jl, ju = j_condense.build_cone_constraints(
            jnp.asarray(m), jnp.asarray(fmax), jnp.asarray(contact), horizon)
        for got, want in ((a, ja), (l, jl), (u, ju)):
            _close(got, want, rtol=0, atol=0)
    assert a.shape == (B, condense.CONE_ROWS * 4 * horizon, 12 * horizon)
    u_rows = u.numpy().reshape(B, horizon, 4, condense.CONE_ROWS)
    assert np.all(u_rows[..., 4][contact == 0] == 0.0)


@pytest.mark.parametrize("horizon", [5, 10])
def test_cost_and_qp_match_jax(horizon):
    """condense_cost and condense_qp against JAX (P to 1e-5 relative with
    a 1e-5 floor, q with a 1e-3 floor), and the dense cost against the
    port's structured one (the JAX test's 1e-7 / 1e-6 limits, P and q
    relative 1e-5)."""
    ad, bd, a_ct, x0, x_des = _model(horizon, 2)
    w = np.asarray(W, np.float32)
    p, q = condense.condense_cost(tt(ad), tt(bd), tt(x0), tt(x_des), tt(w),
                                  4e-6, horizon)
    jp, jq = j_condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, horizon)
    _close(p, jp, rtol=1e-5, atol=1e-5)
    _close(q, jq, rtol=1e-5, atol=1e-3)
    ps, qs = condense.condense_cost_structured(
        tt(a_ct), tt(bd), tt(ad), tt(x0), tt(x_des), tt(w), 4e-6, horizon,
        0.03)
    _close(p, ps.numpy(), rtol=1e-5, atol=1e-7)
    _close(q, qs.numpy(), rtol=1e-5, atol=1e-6)

    contact = _contact(horizon, 3)
    mu, fmax = np.float32(0.45), np.float32(130.0)
    cqp = condense.condense_qp(tt(ad), tt(bd), tt(x0), tt(x_des), tt(w),
                               4e-6, tt(mu), tt(fmax), tt(contact), horizon)
    jcqp = j_condense.condense_qp(ad, bd, x0, x_des, w, 4e-6, mu, fmax,
                                  contact, horizon)
    assert isinstance(cqp, condense.CondensedQP)
    _close(cqp.p, jcqp.p, rtol=1e-5, atol=1e-5)
    _close(cqp.q, jcqp.q, rtol=1e-5, atol=1e-3)
    for f in ("a", "l", "u"):
        _close(getattr(cqp, f), getattr(jcqp, f), rtol=0, atol=0)


# --- the twin of tests/test_warm_start_cadence.py ----------------------------

H = 10
DT = 0.03
CFG = MpcConfig()


def problem_at(t, params, weights):
    """The port's build of test_warm_start_cadence.problem_at (one
    scenario, a leading batch axis of 1): a slowly varying trot problem
    through the dense condensation."""
    rpy = tt([0.02 * np.sin(3 * t), 0.02 * np.cos(2 * t), 0.1 * t])
    feet = tt(np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
              + 0.02 * np.sin(t * 5))
    a, b = srb.srb_continuous(se3.rpy_to_rotmat(rpy), params.total_inertia,
                              params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, b, DT)
    x0 = srb.srb_initial_state(
        rpy, tt([0.4 * t, 0.0, 0.27 + 0.01 * np.sin(4 * t)]),
        tt([0.0, 0.0, 0.1]), tt([0.4, 0.0, 0.0]))
    x_des = x0.repeat(H, 1)
    x_des[:, 9] = 0.4
    p, q = condense.condense_cost(ad, bd, x0, x_des, weights, 4e-6, H)
    phase = (np.arange(H) * DT / 0.6 + t / 0.6) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    contact = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=1)
    contact[0] = 1.0
    fz_hi = tt(contact.reshape(H * 4)) * params.max_force
    return cone_qp.ConeQP(p=p[None], q=q[None], mu=tt([0.45]),
                          fz_lo=torch.zeros(1, H * 4), fz_hi=fz_hi[None])


def solve_production(prob, iters, x0=None, y0=None):
    return cone_qp.solve(prob, iters=iters, alpha=CFG.qp_alpha,
                         accel_restart=CFG.qp_accel_restart, x0=x0, y0=y0)


def test_cadence_solves_track_converged():
    """The JAX test's claims on the port: over 8 cadence steps of the hard
    trot sequence, the production schedule (qp_cold_iters relaxed boot,
    then warm qp_iters) stays within 8% m*g of a 1200-iteration solve on
    the first-step forces, does not blow up, and beats an always-cold
    24-iteration budget. Each step's problem equals JAX's problem_at
    (P, q to 1e-5 relative, floors 1e-5 / 1e-3; the pin pattern exactly)."""
    params = a1_params("cpu")
    weights = tt(W)
    jparams = j_a1()
    jweights = jnp.asarray(W, jnp.float32)
    scale = float(params.total_mass) * 9.81
    x_warm = y_warm = None
    errs_warm, errs_cold24 = [], []
    for k in range(8):
        prob = problem_at(0.03 * k, params, weights)
        jprob = jax_problem_at(0.03 * k, jparams, jweights)
        _close(prob.p[0], jprob.p, rtol=1e-5, atol=1e-5)
        _close(prob.q[0], jprob.q, rtol=1e-5, atol=1e-3)
        _close(prob.fz_hi[0], jprob.fz_hi, rtol=0, atol=0)
        ref = solve_production(prob, iters=1200)
        cold24 = solve_production(prob, iters=CFG.qp_iters)
        if x_warm is None:
            sol = cone_qp.solve(prob, iters=CFG.qp_cold_iters,
                                alpha=CFG.qp_cold_alpha, accel_restart=0)
        else:
            sol = solve_production(prob, iters=CFG.qp_iters, x0=x_warm,
                                   y0=y_warm)
        x_warm, y_warm = sol.x, sol.y
        errs_warm.append((sol.x - ref.x)[0, :12].abs().max().item())
        errs_cold24.append((cold24.x - ref.x)[0, :12].abs().max().item())
    assert max(errs_warm) < 0.08 * scale, errs_warm
    assert errs_warm[-1] < 2.5 * max(errs_warm[0], 1.0)
    assert max(errs_warm) < max(errs_cold24), (errs_warm, errs_cold24)
