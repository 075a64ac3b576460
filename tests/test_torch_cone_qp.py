"""The port's cone QP solve against the JAX package's `solve` / `solve_fused`.

The port's `solve` runs its ADMM loop through `fused_admm` (on CPU, the
plain version). Problems are built like tests/test_pallas_admm.py's.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu.solvers import cone_qp as jcq
from quadruped_tpu_torch.solvers import cone_qp as tcq
from test_torch_fused_admm import B, _jax_problem

MG = 13.0 * 9.81


def _port_problem(prob):
    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    return tcq.ConeQP(p=tt(prob.p), q=tt(prob.q), mu=tt(prob.mu).expand(B),
                      fz_lo=tt(prob.fz_lo), fz_hi=tt(prob.fz_hi))


# (JAX entry point, scheme): the relaxed 30-iteration scheme cold, and the
# production Fast-ADMM 24-iteration scheme warm-started from a boot solve.
CASES = [("solve", "relaxed"), ("solve_fused", "relaxed"),
         ("solve", "accel_warm"), ("solve_fused", "accel_warm")]


@pytest.mark.parametrize("jax_fn,scheme", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_solve_matches_jax(jax_fn, scheme):
    """ns_f32_polish=2 (both inverses converged) and the gate of
    tests/test_pallas_admm.py: atol 5e-2, rtol 1e-3 on x and y."""
    prob = _jax_problem(seed=3)
    kw = dict(iters=30, ns_f32_polish=2)
    warm = {}
    if scheme == "accel_warm":
        boot = jcq.solve(prob, iters=300, ns_f32_polish=2)
        kw = dict(iters=24, alpha=1.0, accel_restart=20, ns_f32_polish=2)
        warm = dict(x0=boot.x, y0=boot.y)
    extra = {"tile": B} if jax_fn == "solve_fused" else {}
    ref = getattr(jcq, jax_fn)(prob, **kw, **warm, **extra)
    port_warm = {k: torch.from_numpy(np.array(v)) for k, v in warm.items()}
    sol = tcq.solve(_port_problem(prob), **kw, **port_warm)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x),
                               atol=5e-2, rtol=1e-3)
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y),
                               atol=5e-2, rtol=1e-3)
    np.testing.assert_allclose(sol.prim_res.numpy(),
                               np.asarray(ref.prim_res), atol=5e-3)


def test_production_polish_first_step_forces():
    """Production ns_f32_polish=1, 24 warm Fast-ADMM iterations: first-step
    forces within 3% m*g of the JAX solve (the golden-parity number). The
    single f32 polish leaves each inverse at ~1e-4 relative error, which
    differs between the two implementations' bf16 steps."""
    prob = _jax_problem(seed=4)
    boot = jcq.solve(prob, iters=300)
    kw = dict(iters=24, alpha=1.0, accel_restart=20, ns_f32_polish=1)
    ref = jcq.solve(prob, x0=boot.x, y0=boot.y, **kw)
    sol = tcq.solve(_port_problem(prob), x0=torch.from_numpy(np.array(boot.x)),
                    y0=torch.from_numpy(np.array(boot.y)), **kw)
    err = np.max(np.abs(sol.x.numpy()[:, :12] - np.asarray(ref.x)[:, :12]))
    assert err < 0.03 * MG, err


@pytest.mark.parametrize("polish,tol", [(1, 1e-3), (2, 1e-5)])
def test_newton_schulz_inverse_matches_jax(polish, tol):
    """The mixed-precision Newton-Schulz inverse, same M: max relative
    entry difference. One f32 polish step leaves the bf16 stage's rounding
    differences at ~1e-4; the second squares them away."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 24, 24)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) / 24 + np.eye(24, dtype=np.float32)
    ref = np.asarray(jcq.newton_schulz_inverse(m, 11, polish))
    got = tcq.newton_schulz_inverse(torch.from_numpy(m), 11, polish).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < tol
