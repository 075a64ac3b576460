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

from card_device import cuda_device  # noqa: F401
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
    port's I / ||M||. Both polish with the same 3-pass bf16 split
    (`dot_3pass`, `_dot_f32_3pass`), and the two inverses differ only where
    the products sum in another order, so a bf16 rounding tie of a step can
    fall either way.
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
    JAX `solve`, prim_res < 1e-2), plus the same x gate against the JAX
    `solve_fused_full` (interpret mode), and each problem's prim_res within
    1e-3 of that solve's (measured <= 2e-4): the two polish with the same
    3-pass split. At n96 relaxed the reference's own fused solve ends at
    prim_res 0.032 (the 3-pass polish leaves the move-blocked inverse less
    exact than a float32 one), so there the absolute gate is the
    reference's value plus the same 1e-3."""
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
    want_res = np.asarray(ref_full.prim_res)
    np.testing.assert_allclose(sol.prim_res.numpy(), want_res, rtol=0,
                               atol=1e-3)
    assert float(sol.prim_res.max()) < max(1e-2, want_res.max() + 1e-3)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version (bit-identical),
    counts no launch, and the inverse it returns is converged."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(4, horizon=4, device="cpu")
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
    """The kernel pads M to 128 x 128, as the Pallas kernel does (N_PAD), so
    the wrapper refuses n > 128 on every device: n = 132 (the largest the
    PR-2 design took) and H=16 unblocked (n = 192). At n <= 128 one block
    takes at most half of an SM's 228 KB, less 1 KB the card reserves per
    block, so two problems share an SM."""
    assert tff.N_PAD == 128
    assert tff.SMEM_BYTES <= (233472 // 2) - 1024
    for n in (132, 192):
        b, m = 2, 5 * n // 3
        z = torch.zeros
        with pytest.raises(ValueError, match="n <= 128"):
            tff.fused_full_solve(torch.eye(n).expand(b, n, n), z(b, n),
                                 z(b), z(b, m), z(b, m), z(b, m) + 1,
                                 z(b, n), z(b, m), ns_iters=11,
                                 ns_f32_polish=1, iters=1, sigma=tcq.SIGMA,
                                 alpha=1.0)


@pytest.mark.parametrize("shape", [(4, 120, 120), (3, 48, 7)],
                         ids=["square", "rect"])
def test_dot_3pass_matches_pallas_split(shape):
    """The plain polish product against the Pallas kernel's
    `_dot_f32_3pass` on the same float32 operands: the same bf16 hi/lo
    split and the same three products of bf16 values, which are exact in
    float32, so only the summation order inside a product differs
    (relative 1e-6 of the operands' scale)."""
    import jax.numpy as jnp

    from quadruped_tpu.solvers import pallas_admm

    b, n, k = shape
    rng = np.random.default_rng(7)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    c = rng.normal(size=(b, n, k)).astype(np.float32)
    got = tff.dot_3pass(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    want = np.stack([np.asarray(pallas_admm._dot_f32_3pass(
        jnp.asarray(a[i]), jnp.asarray(c[i]))) for i in range(b)])
    scale = np.abs(a).max() * np.abs(c).max() * n
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    # It is the float32 product to ~2^-16 relative, not the bf16 one.
    exact = np.einsum("bij,bjk->bik", a.astype(np.float64),
                      c.astype(np.float64))
    assert np.abs(got - exact).max() < 1e-4 * scale


@pytest.mark.parametrize("n", [48, 120])
def test_zero_padding_keeps_the_live_block(n):
    """The kernel's padding rule on the CPU: Newton-Schulz (10 bf16 steps,
    one 3-pass polish) on M padded with zeros to 128, from X0 zero outside
    the live block, equals the live iteration in the live n x n block, and
    is exactly zero outside it (2I - MX is 2 on the pad diagonal)."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(3, horizon=n // 12, device="cpu")
    m_mat, _ = tcq.admm_operands(prob, tcq.RHO_CONE, tcq.SIGMA, None, None)
    padded = torch.zeros(3, tff.N_PAD, tff.N_PAD)
    padded[:, :n, :n] = m_mat
    live = tff.newton_schulz_reference(m_mat, tcq.NS_ITERS, 1)
    full = tff.newton_schulz_reference(padded, tcq.NS_ITERS, 1, live=n)
    torch.testing.assert_close(full[:, :n, :n], live, rtol=0, atol=0)
    assert not full[:, n:, :].any() and not full[:, :, n:].any()
    eye = torch.eye(n)
    assert float((eye - torch.bmm(m_mat, live)).abs().max()) < 5e-3


def _bench_operands(batch, horizon, move_block, scheme, dev):
    """K2's operands, the unscaling d and kwargs of the bench problems
    (`bench.build_bench`, route `loop`): `cold`, the boot's 400 relaxed
    iterations from zero; `warm`, the production Fast-ADMM update from the
    boot's solution; `update`, the bench's timed update at its
    configuration. Newton-Schulz as cone_qp runs it."""
    from quadruped_tpu_torch import bench

    _, args, cfg = bench.build_bench(batch, "loop", horizon, move_block,
                                     device=dev)
    prob = bench.cadence_problem(cfg, bench.a1_params(dev), *args[:4])
    warm = (None, None) if scheme == "cold" else args[4:6]
    m_mat, inp = tcq.admm_operands(prob, tcq.RHO_CONE, tcq.SIGMA, *warm)
    kw = {"cold": dict(iters=400, alpha=1.6, accel_restart=0),
          "warm": dict(iters=24, alpha=1.0, accel_restart=20),
          "update": dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                         accel_restart=cfg.qp_accel_restart)}[scheme]
    ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0)
    return ops, inp.d, dict(kw, sigma=tcq.SIGMA, ns_iters=tcq.NS_ITERS,
                            ns_f32_polish=1)


# (batch, horizon, move_block, scheme): the closed loop's test size in the
# boot scheme at n = 120, 96 and 48; the closed loop's B=2048 at H=10 and
# H=16 (move blocking (4, 2)) in both schemes; the bench's B=8192 update.
CARD_CASES = {
    "h10": (256, 10, (), "cold"),
    "h16_block_4_2": (256, 16, (4, 2), "cold"),
    "h10_block_6_2": (256, 10, (6, 2), "cold"),
    "h4": (256, 4, (), "cold"),
    "h10-b2048-cold": (2048, 10, None, "cold"),
    "h10-b2048-warm": (2048, 10, None, "warm"),
    "h16-b2048-cold": (2048, 16, None, "cold"),
    "h16-b2048-warm": (2048, 16, None, "warm"),
    "h10-b8192-update": (8192, 10, None, "update"),
    "h16-b8192-update": (8192, 16, None, "update"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """CUDA kernel vs its plain version on the same card and inputs. The
    Newton-Schulz residual max|I - M X| of both below 5e-3 (one 3-pass
    polish step leaves ~1e-3 on the hardest problems) and within 1e-4 of
    each other, and the unscaled forces within 0.5 N (0.4% m*g): on the card
    the plain version's bf16 steps are bf16 tensor-core products too
    (`bf16_product`), but the polish and the ADMM loop sum in other orders,
    which the loop amplifies; nothing else differs. The bf16 steps alone
    (no polish, no iteration) sum the same products in the same order in
    both, and agree bit for bit."""
    ops, d, kw = _bench_operands(*CARD_CASES[case], cuda_device)
    xk, _, ik = tff.fused_full_solve(*ops, **kw, return_inverse=True)
    xr, _, ir = tff.fused_full_solve_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all()
    eye = torch.eye(ops[0].shape[-1], device=cuda_device)
    res = [float((eye - torch.bmm(ops[0], inv)).abs().max())
           for inv in (ik, ir)]
    assert max(res) < 5e-3 and abs(res[0] - res[1]) <= 1e-4
    assert float((xk * d - xr * d).abs().max()) < 0.5
    steps = dict(kw, ns_iters=kw["ns_iters"] - kw["ns_f32_polish"],
                 ns_f32_polish=0, iters=0)
    _, _, ib = tff.fused_full_solve(*ops, **steps, return_inverse=True)
    assert torch.equal(ib, tff.newton_schulz_reference(
        ops[0], steps["ns_iters"], 0))
