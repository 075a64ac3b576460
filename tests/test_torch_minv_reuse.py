"""The port's cross-cadence M^{-1} reuse (cone_qp.InverseCarry,
seeded_inverse, _capacitance_inverse) against the JAX package, on the CPU.

Problems are the cadence sequence of tests/test_golden_parity.py
(`cadence_case_at`, trot pins flipping every other step from step 6),
built by the JAX package for scenario seeds 0 and 1 and stacked into a
batch of 2; the port takes the same arrays. Carries come from JAX solves,
so both packages get the same carry and the same M. Then the twins of
tests/test_minv_reuse.py's three tests on the port, a carry mixed across
rho values, and the port's opt-in rescue of a seed whose polish diverges
(scenario 738 of the bench's B=8192 batch, which diverges in JAX too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.solvers import cone_qp as jcq
from quadruped_tpu_torch.solvers import cone_qp as tcq
from test_golden_parity import build_prob, cadence_case_at

torch.set_num_threads(1)

CADENCE_S = 0.015
SEEDS = (0, 1)
MG = 13.0 * 9.81
N = 120


def _jax_prob(step, seeds=SEEDS):
    """The batched JAX ConeQP of cadence step `step` (mu shared)."""
    probs = [build_prob(*cadence_case_at(step * CADENCE_S, s))
             for s in seeds]

    def stack(f):
        return np.stack([np.asarray(getattr(p, f)) for p in probs])

    return jcq.ConeQP(p=stack("p"), q=stack("q"),
                      mu=jnp.asarray(0.45, jnp.float32),
                      fz_lo=stack("fz_lo"), fz_hi=stack("fz_hi"))


def _port(jprob):
    b = jprob.p.shape[0]

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    return tcq.ConeQP(p=tt(jprob.p), q=tt(jprob.q),
                      mu=tt(jprob.mu).expand(b).contiguous(),
                      fz_lo=tt(jprob.fz_lo), fz_hi=tt(jprob.fz_hi))


def _to_port(carry):
    return tcq.InverseCarry(*[torch.from_numpy(np.array(v)) for v in carry])


def _setup(step_carry, step_new, rho=tcq.RHO_CONE):
    """(JAX carry of a 400-iteration solve at step_carry built with rho,
    the port's M and inputs of step_new at the default rho)."""
    _, carry = jcq.solve(_jax_prob(step_carry), iters=400, rho=rho,
                         return_inv_carry=True)
    m, inp = tcq.admm_operands(_port(_jax_prob(step_new)), tcq.RHO_CONE,
                               tcq.SIGMA, None, None)
    return carry, m, inp


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


# (carry step, new step): no flip, 4 flips a scenario after a quiet step,
# 4 flips against a carry one step old, and 12 flips against the boot's
# carry (its seed fails the probe test and takes the damped branch).
STEPS = [(5, 6), (0, 6), (7, 8), (0, 10)]


@pytest.mark.parametrize("step_carry,step_new", STEPS,
                         ids=[f"{a}to{b}" for a, b in STEPS])
def test_seeded_inverse_matches_jax(step_carry, step_new):
    """seeded_inverse on the same M and carry: max relative entry
    difference 1e-3, the port's Newton-Schulz tolerance after one float32
    polish (tests/test_torch_cone_qp.py; measured 0.9-1.9e-4); the
    capacitance inverse of the Woodbury step, an exact T-step scan, to
    1e-5 (measured ~1e-6)."""
    carry, m, inp = _setup(step_carry, step_new)
    rho = tcq.RHO_CONE
    got = tcq.seeded_inverse(m, _to_port(carry), inp.d_t, inp.gamma,
                             inp.pinned, rho)
    want = jcq.seeded_inverse(m.numpy(), carry, inp.d_t.numpy(),
                              inp.gamma.numpy(), inp.pinned.numpy(), rho)
    assert _rel(got.numpy(), want) < 1e-3
    x = np.asarray(carry.m_inv)
    s_cap = np.ascontiguousarray(x[:, 2::3, 2::3])
    c = (99.0 * (rho * inp.pinned.numpy()
                 - rho * np.asarray(carry.pinned))).astype(np.float32)
    got = tcq._capacitance_inverse(torch.from_numpy(s_cap),
                                   torch.from_numpy(c))
    assert _rel(got.numpy(), jcq._capacitance_inverse(s_cap, c)) < 1e-5


def test_mixed_rho_carry():
    """A carry whose scenarios were built at rho 0.05 and 0.06, seeded at
    0.05 across 4 pin flips: the port equals JAX (1e-3 relative), each
    scenario equals the seeded inverse from its own unmixed carry (1e-6
    relative), and the Woodbury step sizes the removed jumps with the
    carry's own rho: the 0.06 scenario's residual max|I - M X| stays at
    the 0.05 one's size (~8e-4, limit 2e-3), where the same carry
    labelled 0.05 leaves ~3e-2."""
    carry5, m, inp = _setup(5, 6, 0.05)
    carry6, _, _ = _setup(5, 6, 0.06)
    mixed = jcq.InverseCarry(*[np.stack([np.asarray(a)[0], np.asarray(b)[1]])
                               for a, b in zip(carry5, carry6)])
    assert np.allclose(np.asarray(mixed.rho), [0.05, 0.06])
    args = (inp.d_t, inp.gamma, inp.pinned, 0.05)
    got = tcq.seeded_inverse(m, _to_port(mixed), *args)
    want = jcq.seeded_inverse(m.numpy(), mixed,
                              *[a.numpy() for a in args[:3]], 0.05)
    assert _rel(got.numpy(), want) < 1e-3
    for i, carry in enumerate((carry5, carry6)):
        alone = tcq.seeded_inverse(m, _to_port(carry), *args)
        assert _rel(got[i].numpy(), alone[i].numpy()) < 1e-6
    eye = torch.eye(N)
    resid = (eye - m @ got).abs().amax(dim=(-2, -1))
    assert float(resid.max()) < 2e-3, resid
    mislabelled = tcq.seeded_inverse(
        m, _to_port(mixed)._replace(rho=torch.tensor([0.05, 0.05])), *args)
    assert float((eye - m[1] @ mislabelled[1]).abs().max()) > 1e-2


def _chain(n_steps, use_carry, package="port", seeds=SEEDS):
    """Cold boot at step 0, then warm production solves; first-step forces
    [n_steps, B, 12] and the pin patterns seen."""
    mod = tcq if package == "port" else jcq
    x = y = carry = None
    forces, pins = [], []
    for k in range(n_steps):
        jprob = _jax_prob(k, seeds)
        prob = _port(jprob) if package == "port" else jprob
        pins.append(np.asarray(jprob.fz_hi) < 1e-6)
        if x is None:
            sol, carry = mod.solve(prob, iters=400, return_inv_carry=True)
        elif use_carry:
            sol, carry = mod.solve(prob, iters=24, alpha=1.0,
                                   accel_restart=20, x0=x, y0=y,
                                   inv_carry=carry, return_inv_carry=True)
        else:
            sol = mod.solve(prob, iters=24, alpha=1.0, accel_restart=20,
                            x0=x, y0=y)
        x, y = sol.x, sol.y
        forces.append(np.asarray(sol.x[:, :12]))
    return np.stack(forces), pins


def test_seeded_matches_cold_across_flips():
    """10 chained cadence solves across trot pin flips: the port's seeded
    path within 0.5% m*g of its cold path at every step (the JAX test's
    limit; measured 0.35%), and within 1% m*g of the JAX seeded chain
    (measured 0.28%: two single-polish inverses, each ~1e-4 off, through
    24 Fast-ADMM iterations a step)."""
    f_cold, pins = _chain(10, use_carry=False)
    f_seed, _ = _chain(10, use_carry=True)
    n_flips = sum(int((pins[k] != pins[k - 1]).sum())
                  for k in range(1, len(pins)))
    assert n_flips > 0, "sequence must exercise pin flips"
    err = np.abs(f_seed - f_cold).max()
    assert err < 0.005 * MG, f"{err / MG * 100:.3f}% m*g"
    f_jax, _ = _chain(10, use_carry=True, package="jax")
    err = np.abs(f_seed - f_jax).max()
    assert err < 0.01 * MG, f"{err / MG * 100:.3f}% m*g"


def test_fallback_stays_finite():
    """A garbage carry (the inverse of an unrelated, badly scaled system)
    takes the damped or cold seed: finite forces bounded by 20 m*g (the
    JAX test), within 1% m*g of JAX's solve from the same carry (measured
    7e-5)."""
    jprob = _jax_prob(0)
    t = N // 3
    bad = dict(m_inv=np.broadcast_to(np.eye(N, dtype=np.float32) * 37.0,
                                     (2, N, N)),
               d_t=np.full((2, t), 5.0, np.float32),
               gamma=np.full((2,), 40.0, np.float32),
               pinned=np.zeros((2, t), np.float32))
    kw = dict(iters=24, alpha=1.0, accel_restart=20)
    sol = tcq.solve(_port(jprob), **kw, inv_carry=tcq.InverseCarry(
        **{k: torch.from_numpy(np.array(v)) for k, v in bad.items()}))
    x = sol.x.numpy()
    assert np.isfinite(x).all()
    assert np.abs(x).max() < 20.0 * MG
    ref = jcq.solve(jprob, **kw, inv_carry=jcq.InverseCarry(
        **{k: jnp.asarray(v) for k, v in bad.items()}))
    assert np.abs(x - np.asarray(ref.x)).max() < 0.01 * MG


def test_long_chain_no_accumulation():
    """40 chained solves (scenario seed 1, the JAX test's), seeded and cold,
    each against a 2000-iteration solve at every step: the seeded path
    never exceeds the cold path's error by more than 1% m*g (measured
    0.18%): the polish contracts to the current M every step."""
    x = y = carry = None
    xc = yc = None
    excess = []
    for k in range(40):
        prob = _port(_jax_prob(k, (1,)))
        if x is None:
            sol, carry = tcq.solve(prob, iters=400, return_inv_carry=True)
            solc = tcq.solve(prob, iters=400)
        else:
            sol, carry = tcq.solve(prob, iters=24, alpha=1.0,
                                   accel_restart=20, x0=x, y0=y,
                                   inv_carry=carry, return_inv_carry=True)
            solc = tcq.solve(prob, iters=24, alpha=1.0, accel_restart=20,
                             x0=xc, y0=yc)
        x, y = sol.x, sol.y
        xc, yc = solc.x, solc.y
        oracle = tcq.solve(prob, iters=2000)
        es = (sol.x - oracle.x)[:, :12].abs().max().item() / MG
        ec = (solc.x - oracle.x)[:, :12].abs().max().item() / MG
        assert np.isfinite(es)
        excess.append(es - ec)
    assert max(excess) < 0.01, f"worst excess {max(excess) * 100:.2f}% m*g"


def test_carry_fields():
    """solve(return_inv_carry=True) returns the carry JAX returns: the same
    shapes, rho batch-shaped, scales and pins equal to float32 roundoff,
    the inverse to the cold Newton-Schulz tolerance (1e-3 relative)."""
    jprob = _jax_prob(6)
    _, jcarry = jcq.solve(jprob, iters=30, return_inv_carry=True)
    _, carry = tcq.solve(_port(jprob), iters=30, return_inv_carry=True)
    for name in tcq.InverseCarry._fields:
        got, want = getattr(carry, name), np.asarray(getattr(jcarry, name))
        assert tuple(got.shape) == want.shape, name
    assert _rel(carry.m_inv.numpy(), jcarry.m_inv) < 1e-3
    for name in ("d_t", "gamma", "pinned", "rho"):
        np.testing.assert_allclose(getattr(carry, name).numpy(),
                                   np.asarray(getattr(jcarry, name)),
                                   rtol=1e-6, err_msg=name)


def _bench_seed(idx):
    """The seeded inverse's inputs for scenarios `idx` of the bench's B=8192
    H=10 batch: the numpy draws of the whole batch
    (quadruped_tpu_torch.bench), the problems, boot and update of `idx`
    only. Returns (M, the boot's carry, the update's AdmmInputs)."""
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.control.mpc import gravity_warm_start
    from quadruped_tpu_torch.robots import a1_params

    params = a1_params("cpu")
    cfg = bench.bench_config(10)
    prev, now = ([t[idx] for t in bench._inputs(8192, ts, cfg.horizon, "cpu")]
                 for ts in (0.0, bench.CADENCE_S))
    prob = bench.cadence_problem(cfg, params, *prev)
    boot, carry = tcq.solve(prob, iters=cfg.qp_cold_iters,
                            alpha=cfg.qp_cold_alpha,
                            x0=gravity_warm_start(params, prev[3]),
                            return_inv_carry=True)
    m, inp = tcq.admm_operands(bench.cadence_problem(cfg, params, *now),
                               tcq.RHO_CONE, tcq.SIGMA, boot.x, boot.y)
    return m, carry, inp


def test_rescue_of_a_diverged_seed():
    """Scenario 738 of the bench's B=8192 H=10 batch releases 8 pins; its
    seed passes the probe test (estimate 0.31, spectral radius of I - M X
    1.79) and the polish diverges to finite values: max|I - M X| ~1.6e8 in
    JAX and in the port alike (a finding in the reference, mirrored by
    default). With rescue_iters the port gives it the cold inverse:
    within 1e-3 relative of the float64 inverse of M (the cold
    single-polish accuracy), counted in `seeded_inverse.rescued`; the
    healthy scenario 0 beside it is left bit for bit as it was."""
    m, carry, inp = _bench_seed([0, 738])
    args = (m, carry, inp.d_t, inp.gamma, inp.pinned, tcq.RHO_CONE)
    eye = torch.eye(N)
    plain = tcq.seeded_inverse(*args)
    want = jcq.seeded_inverse(
        m.numpy(), jcq.InverseCarry(*[np.array(v) for v in carry]),
        inp.d_t.numpy(), inp.gamma.numpy(), inp.pinned.numpy(),
        tcq.RHO_CONE)
    for x in (plain.numpy(), np.asarray(want)):
        resid = np.abs(np.eye(N) - m.numpy() @ x).max(axis=(-2, -1))
        assert resid[0] < 2e-3 and resid[1] > 1e3, resid
    before = tcq.seeded_inverse.rescued
    rescued = tcq.seeded_inverse(*args, rescue_iters=tcq.NS_ITERS)
    assert tcq.seeded_inverse.rescued - before == 1
    assert torch.equal(rescued[0], plain[0])
    oracle = torch.linalg.inv(m[1].double())
    assert _rel(rescued[1].double().numpy(), oracle.numpy()) < 1e-3
    assert float((eye - m[1] @ rescued[1]).abs().max()) < 2e-3


def test_rescue_of_a_garbage_carry():
    """The garbage carry of test_fallback_stays_finite with seed_rescue:
    both scenarios fail the post-polish probe test and take the cold
    inverse, so the solve is the cold solve (1e-4 N)."""
    jprob = _jax_prob(0)
    t = N // 3
    bad = tcq.InverseCarry(m_inv=torch.eye(N).expand(2, N, N) * 37.0,
                           d_t=torch.full((2, t), 5.0),
                           gamma=torch.full((2,), 40.0),
                           pinned=torch.zeros(2, t))
    kw = dict(iters=24, alpha=1.0, accel_restart=20)
    before = tcq.seeded_inverse.rescued
    sol = tcq.solve(_port(jprob), **kw, inv_carry=bad, seed_rescue=True)
    assert tcq.seeded_inverse.rescued - before == 2
    cold = tcq.solve(_port(jprob), **kw)
    assert float((sol.x - cold.x).abs().max()) < 1e-4
