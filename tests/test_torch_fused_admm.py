"""The port's fused ADMM loop (quadruped_tpu_torch/solvers/fused_admm.py).

* On CPU: the plain version `fused_admm_reference` against the JAX Pallas
  kernel `pallas_admm.fused_admm`, which runs in interpret mode on CPU as
  tests/test_pallas_admm.py runs it. Both get the same scaled problem and
  the same M^{-1} (the JAX one, unpadded for the port).
* On the card (marker `cuda`): the CUDA kernel against the plain version at
  B=256, H=10. This module imports no JAX at module level, so the card test
  also runs where JAX is absent:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \
          tests/test_torch_fused_admm.py
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.solvers import cone_qp as tcq
from quadruped_tpu_torch.solvers import fused_admm as tfa

H = 10
B = 8  # interpreter-mode Pallas on CPU is slow; tile = B


def _jax_problem(seed):
    """A batch built like tests/test_pallas_admm.py::build_batch."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.dynamics import srb
    from quadruped_tpu.robots import a1_params
    from quadruped_tpu.solvers import condense, cone_qp

    params = a1_params()
    rng = np.random.default_rng(seed)
    yaw = jnp.asarray(rng.uniform(-1, 1, B), jnp.float32)
    feet = jnp.asarray(
        rng.normal(size=(B, 4, 3)) * 0.04
        + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                    [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]]),
        jnp.float32)
    x0 = jnp.asarray(
        np.concatenate([rng.normal(size=(B, 12)) * 0.05,
                        -9.81 * np.ones((B, 1))], 1), jnp.float32)
    x_des = jnp.tile(x0[:, None, :], (1, H, 1)).at[:, :, 9].set(0.4)
    w = jnp.asarray([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0],
                    jnp.float32)
    a, b = jax.vmap(lambda y, f: srb.srb_continuous(
        y, params.total_inertia, params.total_mass, f))(yaw, feet)
    ad, bd = srb.srb_discretize(a, b, 0.03)
    p, q = condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, H)
    contact = np.ones((B, H, 4), np.float32)
    contact[:, :, 1] = np.tile((np.arange(H) % 2), (B, 1))
    fz_hi = jnp.asarray(contact.reshape(B, H * 4)) * params.max_force
    return cone_qp.ConeQP(p=p, q=q, mu=jnp.asarray(0.45, jnp.float32),
                          fz_lo=jnp.zeros_like(fz_hi), fz_hi=fz_hi)


def _jax_kernel_inputs(prob, x0=None, y0=None):
    """The padded operands cone_qp.solve_fused hands the Pallas kernel."""
    import jax.numpy as jnp

    from quadruped_tpu.solvers import cone_qp, pallas_admm

    b, n, _ = prob.p.shape
    t = n // 3
    p_s, q_s, d, d_t, gamma, fz_lo, fz_hi = cone_qp._equilibrate(prob)
    pattern = cone_qp.cone_pattern(prob.mu, p_s.dtype)
    pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]
    row_template = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0], p_s.dtype)
    rho_rows = cone_qp.RHO_CONE * (1.0 + 99.0 * pinned * row_template)
    ata = jnp.einsum("ir,...tr,rj->...tij", jnp.swapaxes(pattern, -1, -2),
                     rho_rows, pattern)
    m_mat = p_s + cone_qp.SIGMA * jnp.eye(n, dtype=p_s.dtype) \
        + jnp.einsum("...tij,tu->...tiuj", ata,
                     jnp.eye(t, dtype=p_s.dtype)).reshape(b, n, n)
    m_inv = cone_qp.newton_schulz_inverse(m_mat, cone_qp.NS_ITERS, 2)
    np_, mp_ = pallas_admm.N_PAD, pallas_admm.M_PAD
    lo, hi = pallas_admm.cone_bounds_padded(fz_lo, fz_hi, t // 4)
    x_init = jnp.zeros((b, np_), p_s.dtype)
    if x0 is not None:
        x_init = x_init.at[:, :n].set(x0 / d)
    y_init = jnp.zeros((b, mp_), p_s.dtype)
    if y0 is not None:
        y_init = y_init.at[:, :5 * t].set(
            (y0 * gamma[..., None, None]).reshape(b, 5 * t))
    return dict(
        m_inv=jnp.zeros((b, np_, np_), p_s.dtype).at[:, :n, :n].set(m_inv),
        q=jnp.zeros((b, np_), p_s.dtype).at[:, :n].set(q_s),
        mu=prob.mu, lo=lo, hi=hi,
        rho_rows=jnp.ones((b, mp_), p_s.dtype).at[:, :5 * t].set(
            rho_rows.reshape(b, 5 * t)),
        x0=x_init, y0=y_init), n, t


# (name, iters, alpha, accel_restart, warm): the boot solve's relaxed scheme
# and the production warm Fast-ADMM scheme.
CASES = [("relaxed", 30, 1.6, 0, False), ("accel_warm", 24, 1.0, 20, True)]


@pytest.mark.parametrize("name,iters,alpha,restart,warm", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_kernel(name, iters, alpha, restart, warm):
    """Tolerance atol 1e-3 on the scaled iterates (x ~ O(1..100)): both
    loops run the same float32 arithmetic and differ only in summation
    order and in the dense-vs-pattern cone apply."""
    from quadruped_tpu.solvers import cone_qp, pallas_admm

    prob = _jax_problem(seed=5)
    x0 = y0 = None
    if warm:
        boot = cone_qp.solve(prob, iters=200, ns_f32_polish=2)
        x0, y0 = boot.x, boot.y
    ins, n, t = _jax_kernel_inputs(prob, x0, y0)
    xj, yj = pallas_admm.fused_admm(
        **ins, horizon=H, iters=iters, sigma=cone_qp.SIGMA, alpha=alpha,
        accel_restart=restart, tile=B)

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    m = 5 * t
    xt, yt = tfa.fused_admm_reference(
        tt(ins["m_inv"])[:, :n, :n].contiguous(), tt(ins["q"])[:, :n],
        tt(ins["mu"]).expand(B), tt(ins["lo"])[:, :m], tt(ins["hi"])[:, :m],
        tt(ins["rho_rows"])[:, :m], tt(ins["x0"])[:, :n],
        tt(ins["y0"])[:, :m], iters=iters, sigma=tcq.SIGMA, alpha=alpha,
        accel_restart=restart)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj)[:, :n], atol=1e-3)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj)[:, :m], atol=1e-3)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version (bit-identical)
    and counts no kernel launch."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(4, horizon=4)
    inp = tcq.admm_inputs(prob)
    args = (inp.m_inv, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0)
    before = tfa.fused_admm.launches
    x, y = tfa.fused_admm(*args, iters=12, sigma=tcq.SIGMA, alpha=1.0,
                          accel_restart=5)
    xr, yr = tfa.fused_admm_reference(*args, iters=12, sigma=tcq.SIGMA,
                                      alpha=1.0, accel_restart=5)
    assert tfa.fused_admm.launches == before
    assert torch.equal(x, xr) and torch.equal(y, yr)
    with pytest.raises(ValueError):
        tfa.fused_admm(inp.m_inv, inp.q, inp.mu[:2], inp.lo, inp.hi, inp.rho,
                       inp.x0, inp.y0, iters=1, sigma=tcq.SIGMA, alpha=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters,alpha,restart", [(400, 1.6, 0),
                                                 (24, 1.0, 20)],
                         ids=["relaxed_cold", "accel_warm"])
def test_kernel_matches_plain_on_card(cuda_device, iters, alpha, restart):
    """CUDA kernel vs its plain version on the same card and inputs, B=256,
    H=10. Tolerance: max |dx|, |dy| <= 1e-3 + 1e-4 |value| on the scaled
    iterates — the kernel sums the mat-vec in four FMA chains, the plain
    version in cuBLAS order; nothing else differs."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(256, horizon=H, device=cuda_device)
    inp = tcq.admm_inputs(prob)
    if restart:  # warm start from a cold kernel solve, as the cadence does
        x0, y0 = tfa.fused_admm(*inp[:8], iters=400, sigma=tcq.SIGMA,
                                alpha=1.6)
        inp = inp._replace(x0=x0, y0=y0)
    args = inp[:8]
    kw = dict(iters=iters, sigma=tcq.SIGMA, alpha=alpha,
              accel_restart=restart)
    xk, yk = tfa.fused_admm(*args, **kw)
    xr, yr = tfa.fused_admm_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all() and torch.isfinite(yk).all()
    torch.testing.assert_close(xk, xr, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(yk, yr, atol=1e-3, rtol=1e-4)
