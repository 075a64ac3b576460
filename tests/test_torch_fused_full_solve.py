"""The port's fully fused solve (solvers/fused_full_solve.py and
cone_qp.solve_fused_full).

* On CPU: the plain version `fused_full_solve_reference` against the JAX
  Pallas kernel `pallas_admm.fused_full_solve` in interpret mode (B=8,
  tile=B), on the operands the JAX `solve_fused_full` builds (identity tail
  padding for JAX, live sizes for the port); and the port's
  `solve_fused_full` against the JAX `solve_fused_full` and `solve` with
  the gates of tests/test_pallas_admm.py. n = 120 (H=10) and n = 96 (H=10,
  move blocking (6, 2)).
* On the card (marker `cuda`): the CUDA kernel against the plain version.
  This module imports no JAX at module level, so the card test also runs
  where JAX is absent:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \\
          tests/test_torch_fused_full_solve.py
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.solvers import cone_qp as tcq
from quadruped_tpu_torch.solvers import fused_full_solve as tff
from test_torch_fused_admm import B, H, _jax_problem

SIZES = {"n120": None, "n96": (6, 2)}
# (name, iters, alpha, accel_restart, warm): the relaxed boot scheme and the
# production warm Fast-ADMM scheme.
SCHEMES = [("relaxed", 30, 1.6, 0, False), ("accel_warm", 24, 1.0, 20, True)]


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def _problem(size, seed):
    """A JAX cone QP of the test batch, move-blocked for n96."""
    import jax.numpy as jnp

    from quadruped_tpu.solvers import condense, cone_qp

    prob = _jax_problem(seed)
    if SIZES[size] is None:
        return prob
    groups, n_g = condense.move_block_groups(H, *SIZES[size])
    p, q, fz_hi = condense.reduce_move_blocking(prob.p, prob.q, prob.fz_hi,
                                                groups, n_g, H)
    return cone_qp.ConeQP(p=p, q=q, mu=prob.mu, fz_lo=jnp.zeros_like(fz_hi),
                          fz_hi=fz_hi)


def _warm(prob, warm):
    from quadruped_tpu.solvers import cone_qp

    if not warm:
        return None, None
    boot = cone_qp.solve(prob, iters=200, ns_f32_polish=2)
    return boot.x, boot.y


def _port_problem(prob):
    return tcq.ConeQP(p=tt(prob.p), q=tt(prob.q), mu=tt(prob.mu).expand(B),
                      fz_lo=tt(prob.fz_lo), fz_hi=tt(prob.fz_hi))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name,iters,alpha,restart,warm", SCHEMES,
                         ids=[s[0] for s in SCHEMES])
def test_plain_matches_pallas_kernel(size, name, iters, alpha, restart,
                                     warm):
    """Same M, q, bounds, rho and warm start (the port assembles them, live
    sizes; the Pallas kernel gets them padded as the JAX solve_fused_full
    pads them). The equilibrated M's norm exceeds 1 on these problems, so
    the identity tail leaves the Pallas X0 = I / max(||M||, 1) equal to the
    port's I / ||M||. The two inverses differ at ~1e-5 relative: the Pallas
    polish is a 3-pass bf16 split where the port's is float32, and the
    bf16 steps sum in another order, so a rounding tie can fall either way.
    The ADMM loop amplifies that ~100x (measured on CPU: scaled x up to
    1.2e-2 of ~10, y 1e-4, unscaled forces 0.15 N). Tolerances about twice
    that: scaled x atol 2.5e-2, y 5e-4, forces 0.5 N (0.4% m*g)."""
    import jax.numpy as jnp

    from quadruped_tpu.solvers import cone_qp, pallas_admm

    prob = _problem(size, seed=5)
    x0, y0 = _warm(prob, warm)
    m_mat, inp = tcq.admm_operands(
        _port_problem(prob), tcq.RHO_CONE, tcq.SIGMA,
        None if x0 is None else tt(x0), None if y0 is None else tt(y0))
    b, n, _ = m_mat.shape
    m = inp.lo.shape[1]
    norm = torch.amax(torch.sum(torch.abs(m_mat), dim=-1), dim=-1)
    assert float(norm.min()) > 1.0

    np_, mp_ = pallas_admm.N_PAD, pallas_admm.M_PAD

    def pad(a, width, fill=0.0):
        out = np.full((b, width), fill, np.float32)
        out[:, :a.shape[1]] = a.numpy()
        return jnp.asarray(out)

    m_p = np.zeros((b, np_, np_), np.float32)
    m_p[:, :n, :n] = m_mat.numpy()
    m_p[:, np.arange(n, np_), np.arange(n, np_)] = 1.0
    xj, yj = pallas_admm.fused_full_solve(
        jnp.asarray(m_p), pad(inp.q, np_), prob.mu,
        pad(inp.lo, mp_, -pallas_admm.BIG), pad(inp.hi, mp_, pallas_admm.BIG),
        pad(inp.rho, mp_, 1.0), pad(inp.x0, np_), pad(inp.y0, mp_),
        horizon=n // 12, ns_iters=cone_qp.NS_ITERS, ns_f32_polish=1,
        iters=iters, sigma=cone_qp.SIGMA, alpha=alpha,
        accel_restart=restart, tile=B)
    xt, yt, _ = tff.fused_full_solve_reference(
        m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0,
        ns_iters=tcq.NS_ITERS, ns_f32_polish=1, iters=iters,
        sigma=tcq.SIGMA, alpha=alpha, accel_restart=restart)
    xj, yj = np.asarray(xj)[:, :n], np.asarray(yj)[:, :m]
    np.testing.assert_allclose(xt.numpy(), xj, atol=2.5e-2)
    np.testing.assert_allclose(yt.numpy(), yj, atol=5e-4)
    d = inp.d.numpy()
    np.testing.assert_allclose(xt.numpy() * d, xj * d, atol=0.5)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name,iters,alpha,restart,warm",
                         [("relaxed", 120, 1.6, 0, False),
                          ("accel_warm", 24, 1.0, 20, True)],
                         ids=["relaxed", "accel_warm"])
def test_solve_fused_full_matches_jax(size, name, iters, alpha, restart,
                                      warm):
    """The gates of tests/test_pallas_admm.py (x within atol 1.0 N of the
    JAX `solve`, prim_res < 1e-2), plus the same gate against the JAX
    `solve_fused_full` (interpret mode)."""
    from quadruped_tpu.solvers import cone_qp

    prob = _problem(size, seed=2 if name == "relaxed" else 4)
    x0, y0 = _warm(prob, warm)
    kw = dict(iters=iters, alpha=alpha, accel_restart=restart,
              ns_f32_polish=2)
    ref = cone_qp.solve(prob, x0=x0, y0=y0, **kw)
    ref_full = cone_qp.solve_fused_full(prob, x0=x0, y0=y0, tile=B, **kw)
    sol = tcq.solve_fused_full(
        _port_problem(prob), x0=None if x0 is None else tt(x0),
        y0=None if y0 is None else tt(y0), **kw)
    for want in (ref, ref_full):
        np.testing.assert_allclose(sol.x.numpy(), np.asarray(want.x),
                                   atol=1.0)
    assert float(sol.prim_res.max()) < 1e-2


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version (bit-identical),
    counts no launch, and the inverse it returns is converged."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(4, horizon=4)
    m_mat, inp = tcq.admm_operands(prob, tcq.RHO_CONE, tcq.SIGMA, None, None)
    args = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0)
    kw = dict(ns_iters=11, ns_f32_polish=1, iters=12, sigma=tcq.SIGMA,
              alpha=1.0, accel_restart=5)
    before = tff.fused_full_solve.launches
    x, y, m_inv = tff.fused_full_solve(*args, **kw, return_inverse=True)
    xr, yr, m_inv_r = tff.fused_full_solve_reference(*args, **kw)
    assert tff.fused_full_solve.launches == before
    assert torch.equal(x, xr) and torch.equal(y, yr)
    assert torch.equal(m_inv, m_inv_r)
    eye = torch.eye(m_mat.shape[-1])
    assert float((eye - torch.bmm(m_mat, m_inv)).abs().max()) < 1e-3


def test_size_limit():
    """H=16 unblocked (n = 192) does not fit one block's shared memory; the
    wrapper refuses it on every device. n = 132 is the largest that fits."""
    assert tff.smem_bytes(132) <= 232448 < tff.smem_bytes(144)
    b, n = 2, 192
    m = 5 * n // 3
    z = torch.zeros
    with pytest.raises(ValueError, match="shared memory"):
        tff.fused_full_solve(torch.eye(n).expand(b, n, n), z(b, n),
                             z(b), z(b, m), z(b, m), z(b, m) + 1, z(b, n),
                             z(b, m), ns_iters=11, ns_f32_polish=1, iters=1,
                             sigma=tcq.SIGMA, alpha=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("horizon,move_block", [(10, ()), (16, (4, 2)),
                                                (10, (6, 2))],
                         ids=["h10", "h16_block_4_2", "h10_block_6_2"])
def test_kernel_matches_plain_on_card(cuda_device, horizon, move_block):
    """CUDA kernel vs its plain version on the same card and inputs, B=256,
    the 400-iteration relaxed boot scheme. The Newton-Schulz residual
    max|I - M X| of both below 5e-3 (one float32 polish step leaves ~1e-3 on
    the hardest problems) and the unscaled forces within 0.5 N (0.4% m*g):
    the two sum the bf16 products in other orders, so a rounding tie may
    fall differently; nothing else differs."""
    from quadruped_tpu_torch import bench

    _, args, cfg = bench.build_bench(256, "loop", horizon, move_block,
                                     device=cuda_device)
    prob = bench.cadence_problem(cfg, bench.a1_params(cuda_device),
                                 *args[:4])
    m_mat, inp = tcq.admm_operands(prob, tcq.RHO_CONE, tcq.SIGMA, None, None)
    ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0)
    kw = dict(ns_iters=11, ns_f32_polish=1, iters=400, sigma=tcq.SIGMA,
              alpha=1.6)
    xk, _, ik = tff.fused_full_solve(*ops, **kw, return_inverse=True)
    xr, _, ir = tff.fused_full_solve_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all()
    eye = torch.eye(m_mat.shape[-1], device=cuda_device)
    for inv in (ik, ir):
        assert float((eye - torch.bmm(m_mat, inv)).abs().max()) < 5e-3
    assert float((xk * inp.d - xr * inp.d).abs().max()) < 0.5
