"""The port's bf16 ADMM head (cone_qp.solve(bf16_iters=...)) against the JAX
package's `solve`, and K1's z0 start, on the CPU.

The head runs the first bf16_iters relaxed iterations in torch ops as JAX
runs them in XLA (M^{-1} rounded to bf16, rhs as a hi / lo bf16 pair,
float32 sums, second-index contraction); the float32 rest runs in
`fused_admm` (here its plain version) from the head's (x, z, y), as JAX's
float32 scan continues from its carry. Problems as
tests/test_torch_cone_qp.py builds them (B=8, H=10).
"""

import numpy as np
import pytest
import torch

from quadruped_tpu.solvers import cone_qp as jcq
from quadruped_tpu_torch.solvers import cone_qp as tcq
from quadruped_tpu_torch.solvers import fused_admm as tfa
from quadruped_tpu_torch.solvers.fused_admm import _apply_a, _apply_at
from test_torch_cone_qp import _port_problem
from test_torch_fused_admm import _jax_problem

torch.set_num_threads(1)

MG = 13.0 * 9.81


@pytest.mark.parametrize("bf16_iters", [4, 24])
def test_bf16_head_matches_jax(bf16_iters):
    """40 relaxed iterations, the first bf16_iters in bf16, ns_f32_polish=2
    (both inverses converged to ~1e-5). Tolerance: first-step forces 0.5%
    m*g (measured 0.015% / 0.13% at 4 / 24), every force 3% m*g (the
    golden-parity gate; measured 0.14% / 1.1%), duals 1e-3 + 1e-3 |y|
    (measured 1e-4). Rounding M^{-1} to bf16 is a step function: an entry
    whose two float32 values lie on either side of a bf16 rounding
    boundary differs by one bf16 ulp (~4e-3 relative), and the loop
    amplifies operator changes ~100x (the JAX docstring); JAX's own bf16
    head moves the first-step forces 1-7% m*g from its float32 loop on
    these problems, 8-50x the limit here."""
    prob = _jax_problem(seed=3)
    kw = dict(iters=40, bf16_iters=bf16_iters, ns_f32_polish=2)
    ref = jcq.solve(prob, **kw)
    sol = tcq.solve(_port_problem(prob), **kw)
    x, jx = sol.x.numpy(), np.asarray(ref.x)
    assert np.abs(x[:, :12] - jx[:, :12]).max() < 0.005 * MG
    assert np.abs(x - jx).max() < 0.03 * MG
    np.testing.assert_allclose(sol.y.numpy(), np.asarray(ref.y), atol=1e-3,
                               rtol=1e-3)


def test_bf16_head_refuses_fast_admm():
    """bf16_iters with accel_restart raises ValueError, as in JAX."""
    prob = _port_problem(_jax_problem(seed=3))
    with pytest.raises(ValueError, match="accel_restart"):
        tcq.solve(prob, iters=24, alpha=1.0, accel_restart=20, bf16_iters=4)


def test_tail_continues_from_the_head():
    """The float32 tail goes through the fused_admm wrapper from the head's
    z (on the CPU its plain version, which counts no launch): the solve
    equals bf16_head followed by fused_admm with z0, bit for bit; a head
    that takes every iteration leaves no tail."""
    prob = _port_problem(_jax_problem(seed=4))
    inp = tcq.admm_inputs(prob)
    x, z, y = tcq.bf16_head(inp, 4, tcq.SIGMA, tcq.ALPHA)
    xs, _ = tfa.fused_admm(inp.m_inv, inp.q, inp.mu, inp.lo, inp.hi,
                           inp.rho, x, y, z0=z, iters=20, sigma=tcq.SIGMA,
                           alpha=tcq.ALPHA)
    sol = tcq.solve(prob, iters=24, bf16_iters=4)
    assert torch.equal(sol.x, xs * inp.d)
    x_all, _, _ = tcq.bf16_head(inp, 24, tcq.SIGMA, tcq.ALPHA)
    assert torch.equal(tcq.solve(prob, iters=24, bf16_iters=24).x,
                       x_all * inp.d)


def _relaxed_steps(args, z, iters, sigma, alpha):
    """`iters` relaxed iterations written out as fused_admm_reference runs
    them (accel_restart 0: z_hat = z, y_hat = y); returns (x, z, y)."""
    m_inv, q, mu, lo, hi, rho, x, y = args
    rho_inv = 1.0 / rho
    for _ in range(iters):
        rhs = sigma * x - q + _apply_at(rho * z - y, mu)
        x_t = torch.bmm(rhs[:, None, :], m_inv.transpose(1, 2))[:, 0]
        z_t = _apply_a(x_t, mu)
        x = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_new = torch.clamp(z_rel + y * rho_inv, lo, hi)
        y = y + rho * (z_rel - z_new)
        z = z_new
    return x, z, y


@pytest.mark.parametrize("split", [0, 7, 30])
def test_reference_resumes_from_z0(split):
    """fused_admm_reference from a mid-loop state (x, z, y) after `split`
    of 30 relaxed iterations equals the uninterrupted 30-iteration loop
    bit for bit; split 0 with z0 = clip(A x0) is the loop's own start."""
    prob = _port_problem(_jax_problem(seed=5))
    inp = tcq.admm_inputs(prob)
    args = tuple(inp[:8])
    kw = dict(sigma=tcq.SIGMA, alpha=1.6)
    x_ref, y_ref = tfa.fused_admm_reference(*args, iters=30, **kw)
    z0 = torch.clamp(_apply_a(inp.x0, inp.mu), inp.lo, inp.hi)
    x, z, y = _relaxed_steps(args, z0, split, **kw)
    x_got, y_got = tfa.fused_admm_reference(*args[:6], x, y, z0=z,
                                            iters=30 - split, **kw)
    assert torch.equal(x_got, x_ref) and torch.equal(y_got, y_ref)
    with pytest.raises(ValueError, match="z0"):
        tfa.fused_admm(*args, z0=z[:, :5], iters=1, **kw)
