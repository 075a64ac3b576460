"""The port's fused ADMM loop (quadruped_tpu_torch/solvers/fused_admm.py).

* On CPU: the plain version `fused_admm_reference` against the JAX Pallas
  kernel `pallas_admm.fused_admm`, which runs in interpret mode on CPU as
  tests/test_pallas_admm.py runs it. Both get the same scaled problem and
  the same M^{-1} (the JAX one, unpadded and transposed for the port,
  whose loop takes it as the JAX `solve` does).
* On the card (marker `cuda`): the four kernels built together; the CUDA
  kernel against the plain version at B=256, H=5, 10 and 16 (n = 60,
  120, 192), at the closed loop's B=2048, on the bench's B=8192 update
  (cold and seeded), from a carried z0 (the bf16 head's), and on the
  batches the paths hand it (the fleets', the hil tick's, the
  examples'); and the boot solve the closed loop runs at unblocked H=16
  (n = 192, 400 relaxed iterations) held on its unscaled first-step
  forces. This module imports no JAX at module level, so the card tests
  also run where JAX is absent (tests/card_device.py).
"""

import numpy as np
import pytest
import torch

from card_device import cuda_device  # noqa: F401
from quadruped_tpu_torch.solvers import problems

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
    # The Pallas loop contracts over its matrix's first index; the port's
    # takes M^{-1} as the JAX `solve` does (x_t = M^{-1} rhs), so it is
    # given the transpose of the Pallas operand.
    xt, yt = tfa.fused_admm_reference(
        tt(ins["m_inv"])[:, :n, :n].transpose(1, 2).contiguous(),
        tt(ins["q"])[:, :n],
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

    prob, _ = bench_problems(4, horizon=4, device="cpu")
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


@pytest.mark.cuda
def test_the_four_kernels_build_together_on_card(cuda_device):
    """K1, K2, K3 and the dense-QP kernel, one nvcc each, all started
    together (`cuda_build.build_shared_libraries`): each library there."""
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.solvers import fused_full_solve, qp
    from quadruped_tpu_torch.utils import cuda_build

    sources = {"fused_admm": tfa.SOURCE,
               "fused_full_solve": fused_full_solve.SOURCE,
               "unrolled_dots": mxu_rate.SOURCE, "dense_qp": qp.SOURCE}
    built = cuda_build.build_shared_libraries(
        [(src, name) for name, src in sources.items()])
    assert len(built) == len(sources)
    for path, _ in built:
        assert path.is_file(), path


# The operands the card tests hold K1 on: {case: function of the device
# returning (operands, kwargs)}.
def _bench(batch, horizon, iters, alpha, restart, gravity=False):
    """`bench_problems`: the boot's relaxed cold solve, or the production
    warm Fast-ADMM scheme started from a cold kernel solve, as the cadence
    does; `gravity`: the cold start from `gravity_warm_start`, y = 0."""
    def build(dev):
        from quadruped_tpu_torch.control import mpc as mpc_mod
        from quadruped_tpu_torch.robots import a1_params
        from quadruped_tpu_torch.solvers.problems import bench_problems

        prob, table = bench_problems(batch, horizon=horizon, device=dev)
        if gravity:
            inp = tcq.admm_inputs(
                prob, x0=mpc_mod.gravity_warm_start(a1_params(dev), table),
                y0=torch.zeros(batch, 4 * horizon, 5, device=dev))
        else:
            inp = tcq.admm_inputs(prob)
        if restart:
            x0, y0 = tfa.fused_admm(*inp[:8], iters=400, sigma=tcq.SIGMA,
                                    alpha=1.6)
            inp = inp._replace(x0=x0, y0=y0)
        return inp[:8], dict(iters=iters, sigma=tcq.SIGMA, alpha=alpha,
                             accel_restart=restart)
    return build


def _z0(batch, horizon):
    """K1 from a carried z0: the bf16 head's state after 4 relaxed
    iterations, as `cone_qp.solve(bf16_iters=4)` hands it over, then 20
    relaxed iterations."""
    def build(dev):
        from quadruped_tpu_torch.solvers.problems import bench_problems

        prob, _ = bench_problems(batch, horizon=horizon, device=dev)
        inp = tcq.admm_inputs(prob)
        x, z, y = tcq.bf16_head(inp, 4, tcq.SIGMA, tcq.ALPHA)
        return (*inp[:6], x, y), dict(iters=20, sigma=tcq.SIGMA,
                                      alpha=tcq.ALPHA, z0=z)
    return build


def _bench_update(horizon, seeded):
    """The B=8192 MPC update of the bench (`bench.build_bench`, route
    `loop`) as its solve hands it to K1; `seeded`: M^{-1} seeded from the
    boot's inverse carry, with the rescue (`minv_reuse`)."""
    def build(dev):
        from quadruped_tpu_torch import bench

        _, args, cfg = bench.build_bench(8192, "loop", horizon, device=dev,
                                         minv_reuse=seeded)
        prob = bench.cadence_problem(cfg, bench.a1_params(dev), *args[:4])
        kw = dict(iters=cfg.qp_iters, sigma=tcq.SIGMA, alpha=cfg.qp_alpha,
                  accel_restart=cfg.qp_accel_restart)
        if not seeded:
            return tcq.admm_inputs(prob, x0=args[4], y0=args[5])[:8], kw
        m_mat, inp = tcq.admm_operands(prob, tcq.RHO_CONE, tcq.SIGMA,
                                       *args[4:6])
        m_inv = tcq.seeded_inverse(m_mat, args[6], inp.d_t, inp.gamma,
                                   inp.pinned, tcq.RHO_CONE,
                                   rescue_iters=tcq.NS_ITERS)
        return (m_inv, *inp[1:8]), kw
    return build


def _solves(run) -> list:
    """(ConeQP, kwargs) of every `cone_qp.solve` that run() makes."""
    got = []
    solve = tcq.solve

    def spy(prob, **kw):
        got.append((prob, kw))
        return solve(prob, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcq, "solve", spy)
        run()
    return got


def _k1_operands(prob, kw):
    """K1's (operands, kwargs) as `cone_qp.solve(prob, **kw)` hands them
    to the kernel."""
    inp = tcq.admm_inputs(prob, rho=kw.get("rho", tcq.RHO_CONE),
                          x0=kw.get("x0"), y0=kw.get("y0"))
    return inp[:8], dict(iters=kw["iters"], sigma=tcq.SIGMA,
                         alpha=kw.get("alpha", tcq.ALPHA),
                         accel_restart=kw.get("accel_restart", 0))


def captured_k1(run) -> list:
    """K1's (operands, kwargs) in every `cone_qp.solve` that run() makes."""
    return [_k1_operands(prob, kw) for prob, kw in _solves(run)]


def _fleet(row_mu):
    """The first warm MPC solve of the heterogeneous fleet at B=2048
    (benchmarks/fleet.py: four robots' force caps by row); `row_mu`: the
    same batch with mu drawn per row in [0.3, 0.9]."""
    def build(dev):
        import dataclasses

        from quadruped_tpu_torch.benchmarks import fleet
        from quadruped_tpu_torch.sim import rollout as rollout_mod

        f = fleet.build(128, dev)
        prob, kw = _solves(lambda: rollout_mod.rollout_segment(
            f.config, f.params, f.cmd,
            rollout_mod.rollout_init(f.config, f.params, 2048), 9))[-1]
        if row_mu:
            mu = np.random.default_rng(0).uniform(0.3, 0.9, 2048)
            prob = dataclasses.replace(prob, mu=torch.as_tensor(
                mu.astype(np.float32), device=dev))
        return _k1_operands(prob, kw)
    return build


def _wholebody_fleet(dev):
    """The first warm MPC solve of the four robots' whole-body loop at
    B=1024 (benchmarks/fleet_paths.py, n = 120)."""
    from quadruped_tpu_torch.benchmarks import fleet_paths

    return captured_k1(lambda: fleet_paths.run(
        fleet_paths.build("wholebody", 1024, dev), 9))[-1]


def _hil(n):
    """A warm solve of the hil tick (benchmarks/hil_latency.py) at a fleet
    of n robots."""
    def build(dev):
        from quadruped_tpu_torch.benchmarks import hil_latency as hil

        with hil.HilRig(n, dev) as rig:
            rig.run(0, warmup=3)
            calls = captured_k1(lambda: rig.run(9, warmup=0))
        return next(c for c in calls if c[1]["iters"] == 24)
    return build


def _example(name):
    """A 40-iteration warm solve of one example (B=1)."""
    def build(dev):
        from quadruped_tpu_torch.examples import fixture as fx

        calls = captured_k1(lambda: fx.module(name).run(steps=10,
                                                        device=dev))
        return next(c for c in calls if c[1]["iters"] == 40)
    return build


# The closed loop's test size (B=256), production H=10 and H=16 unblocked
# (the register shape of 768 threads) in the boot's 400 relaxed iterations
# and the warm Fast-ADMM scheme, and at the closed loop's B=2048 from the
# gravity start; the bf16 head's z0; the bench's B=8192 update, cold and
# seeded; and the batches the paths hand K1:
# the fleet's per-row force caps (and per-row mu), the whole-body fleet's,
# the hil tick's at B=1 and 16, the examples' at B=1.
CARD_CASES = {
    "relaxed_cold-n60": _bench(256, 5, 400, 1.6, 0),
    "relaxed_cold-n120": _bench(256, 10, 400, 1.6, 0),
    "accel_warm-n60": _bench(256, 5, 24, 1.0, 20),
    "accel_warm-n120": _bench(256, 10, 24, 1.0, 20),
    "accel_warm-n192": _bench(256, 16, 24, 1.0, 20),
    "relaxed_cold-n120-b2048": _bench(2048, 10, 400, 1.6, 0, gravity=True),
    "accel_warm-n120-b2048": _bench(2048, 10, 24, 1.0, 20, gravity=True),
    "z0-n120-b2048": _z0(2048, 10),
    "bench_update-h10-b8192": _bench_update(10, seeded=False),
    "bench_update-h16-b8192": _bench_update(16, seeded=False),
    "seeded_update-h10-b8192": _bench_update(10, seeded=True),
    "seeded_update-h16-b8192": _bench_update(16, seeded=True),
    "fleet-b2048": _fleet(row_mu=False),
    "fleet_row_mu-b2048": _fleet(row_mu=True),
    "wholebody_fleet-b1024": _wholebody_fleet,
    "hil-b1": _hil(1),
    "hil-b16": _hil(16),
    "example_a1_trot-b1-n120": _example("a1_trot"),
    "example_aliengo_wbc_trot-b1-n60": _example("aliengo_wbc_trot"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """CUDA kernel vs its plain version on the same card and operands.
    Tolerance: max |dx|, |dy| <= 1e-3 + 1e-4 |value| on the scaled
    iterates — the kernel sums the mat-vec as 8 or 16 partial sums joined
    by warp shuffles, the plain version in cuBLAS order; nothing else
    differs. At n = 192 the 400 relaxed iterations of the boot amplify that
    change of summation order past this tolerance (two float32 orders of
    the plain loop itself differ as much there), so n = 192 is held in the
    warm scheme, the one the closed loop runs every period, and its boot
    below."""
    args, kw = CARD_CASES[case](cuda_device)
    xk, yk = tfa.fused_admm(*args, **kw)
    xr, yr = tfa.fused_admm_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all() and torch.isfinite(yk).all()
    torch.testing.assert_close(xk, xr, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(yk, yr, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [5, 10, 16])
def test_kernel_z0_matches_plain_on_card(cuda_device, horizon):
    """K1 started from a carried z0 (the state of the bf16 head after 4
    relaxed iterations, as `cone_qp.solve(bf16_iters=4)` hands it over)
    against the plain version from the same z0, 20 relaxed iterations,
    B=256, n = 12 H: the limits of the test above; and z0 = None against
    z0 = clip(A x0, lo, hi), the same start up to the kernel's contraction
    of fx + mu fz into one rounding (the same limits)."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    prob, _ = bench_problems(256, horizon=horizon, device=cuda_device)
    inp = tcq.admm_inputs(prob)
    x, z, y = tcq.bf16_head(inp, 4, tcq.SIGMA, tcq.ALPHA)
    args = (*inp[:6], x, y)
    kw = dict(iters=20, sigma=tcq.SIGMA, alpha=tcq.ALPHA, z0=z)
    xk, yk = tfa.fused_admm(*args, **kw)
    xr, yr = tfa.fused_admm_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all() and torch.isfinite(yk).all()
    torch.testing.assert_close(xk, xr, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(yk, yr, atol=1e-3, rtol=1e-4)
    z_start = torch.clamp(tfa._apply_a(x, inp.mu), inp.lo, inp.hi)
    kw = dict(kw, z0=None)
    xa, ya = tfa.fused_admm(*args, **kw)
    xb, yb = tfa.fused_admm(*args, **dict(kw, z0=z_start))
    torch.testing.assert_close(xa, xb, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(ya, yb, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_bf16_head_solve_on_card_matches_cpu(cuda_device):
    """`cone_qp.solve(bf16_iters=4, iters=24, ns_f32_polish=2)` on the card
    (K1 once, for the float32 tail) against the same solve on the CPU,
    B=256: first-step forces within 0.5% m*g, every force within 3% m*g,
    duals within 1e-3 + 1e-3 |y| (tests/test_torch_bf16_iters.py's limits
    against JAX)."""
    from quadruped_tpu_torch.solvers.problems import bench_problems

    mg = 13.0 * 9.81
    kw = dict(iters=24, bf16_iters=4, ns_f32_polish=2)
    prob, _ = bench_problems(256, horizon=10, device=cuda_device)
    before = tfa.fused_admm.launches
    got = tcq.solve(prob, **kw)
    torch.cuda.synchronize()
    assert tfa.fused_admm.launches - before == 1
    want = tcq.solve(bench_problems(256, horizon=10, device="cpu")[0], **kw)
    dx = (got.x.cpu() - want.x).abs()
    assert dx[:, :12].max().item() <= 0.005 * mg
    assert dx.max().item() <= 0.03 * mg
    assert ((got.y.cpu() - want.y).abs() - 1e-3 * want.y.abs()).max() \
        .item() <= 1e-3


def test_boot_problems_are_the_cold_start():
    """`problems.boot_problems` is the solve `mpc_cold_start` runs: solving
    it as the boot does gives mpc_cold_start's forces exactly (CPU, B=4,
    H=16 unblocked, n = 192)."""
    from quadruped_tpu_torch.control import mpc as mpc_mod

    b = 4
    prob, x0, cfg = problems.boot_problems(b, device="cpu")
    assert prob.q.shape == (b, 192) and cfg.qp_cold_iters == 400
    sol = tcq.solve(prob, iters=cfg.qp_cold_iters, x0=x0,
                    y0=torch.zeros(b, 64, 5), alpha=cfg.qp_cold_alpha,
                    accel_restart=0)
    state = mpc_mod.mpc_cold_start(*problems.boot_states(b, device="cpu"))
    assert torch.equal(state.forces_world, sol.x[:, :12].reshape(b, 4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 2048])
def test_boot_solve_n192_matches_plain_on_card(cuda_device, batch):
    """The closed loop's boot at unblocked MpcConfig(horizon=16): n = 192,
    400 relaxed iterations (alpha 1.6, no restart), B standing robots
    (`problems.boot_problems`). Kernel and plain version on the same card
    operands; their unscaled first-step forces within 1% m*g, the limit of
    tests/test_torch_rollout.py. (The scaled iterates are held at n <= 120
    only, above: at n = 192 the 400 relaxed iterations amplify the change
    of summation order past 1e-3 + 1e-4 |value|.)"""
    prob, x0, cfg = problems.boot_problems(batch, horizon=16,
                                           device=cuda_device)
    assert prob.q.shape[1] == 192
    inp = tcq.admm_inputs(prob, x0=x0,
                          y0=torch.zeros(batch, 64, 5, device=cuda_device))
    kw = dict(iters=cfg.qp_cold_iters, sigma=tcq.SIGMA,
              alpha=cfg.qp_cold_alpha, accel_restart=0)
    xk, yk = tfa.fused_admm(*inp[:8], **kw)
    xr, _ = tfa.fused_admm_reference(*inp[:8], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all() and torch.isfinite(yk).all()
    forces_k = (xk * inp.d)[:, :12]
    forces_r = (xr * inp.d)[:, :12]
    assert (forces_k - forces_r).abs().max().item() <= 0.01 * 13.0 * 9.81
