"""Why the Lite2's whole-body trot parts from JAX's faster than the other
robots' (CPU).

The loop (benchmarks/whole_body.py's tick, `MpcConfig(horizon=5,
qp_iters=24, qp_cold_iters=120)`) resumed from JAX's boot parted from JAX
first on tick 0, in the MPC solve: every earlier stage (the model, the
contact forces, the mass matrix, the bias forces, the QP's P and q) agreed
to float32 rounding (P, q within 7e-8 relative).

* The port's fault, repaired: Newton-Schulz leaves M^{-1} symmetric only
  to ~1e-4, and K1 (as the Pallas loop) contracts over M^{-1}'s first
  index where the JAX `solve` takes M^{-1} rhs. `cone_qp.solve` now gives
  K1 the transpose. Given the same M^{-1}, the two solves then agree to
  float32 rounding (`test_solve_takes_m_inv_as_jax_does`); before, they
  parted by 0.2 N on the Lite2's tick-0 problem.
* Amplified rounding, the rest: the ten bf16 Newton-Schulz steps of each
  package sum their float32 products in another order, the bf16 cast turns
  a last-bit difference into a bf16 step (4e-3) on some entries, and the
  one float32 polish leaves the two inverses ~1.3e-4 apart; the warm ADMM
  carries that into 0.09 N on the Lite2's tick 0, where the feet start
  5 cm into the ground. With the same exact inverse in both packages (a
  float64 inverse in place of `newton_schulz_inverse`, patched into both
  for the test), the Lite2's loop stays within JAX's own spread under a
  one-float32-step nudge of a joint angle
  (`test_lite2_loop_within_jax_spread_without_bf16_inverse`). The
  float32 loop with both packages' own inverses joins
  tests/test_torch_fleet_whole_body.py's fleet at its CLOSED_TOL.
"""

import numpy as np
import torch

torch.set_num_threads(1)

DT = 0.002
TICKS = 40
VX = np.float32(0.3)
# The port against JAX with the same exact inverse, as a multiple of JAX
# against itself from a start nudged by one float32 step of a joint angle
# (CPU reading: 0.93).
SPREAD_MULTIPLE = 3.0


def _np_inverse(m):
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


def _patch_exact_inverse(monkeypatch):
    """Both packages' Newton-Schulz inverse -> the float64 inverse rounded
    to float32 (JAX through a host callback)."""
    import jax

    from quadruped_tpu.solvers import cone_qp as jcq
    from quadruped_tpu_torch.solvers import cone_qp as tcq

    monkeypatch.setattr(jcq, "newton_schulz_inverse", lambda m, *a, **k:
                        jax.pure_callback(
                            _np_inverse, jax.ShapeDtypeStruct(m.shape,
                                                              m.dtype),
                            m, vmap_method="sequential"))
    monkeypatch.setattr(tcq, "newton_schulz_inverse", lambda m, *a, **k:
                        torch.from_numpy(_np_inverse(m.numpy())))


def _jax_loop(robot: str):
    """JAX's boot of `robot` alone and its jitted closed-loop tick."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as jm, swing as js
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import (LocomotionConfig,
                                                  locomotion_init,
                                                  locomotion_step)
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.gait import ADVANCED_TROT as JAT
    from quadruped_tpu.robots import named_params
    from quadruped_tpu.sim import whole_body as jwb

    from fleet_cases import heights

    cfg = LocomotionConfig(mpc=jm.MpcConfig(horizon=5, qp_iters=24,
                                            qp_cold_iters=120),
                           swing=js.SwingConfig(), gait=JAT())
    p = named_params(robot)
    model = jfb.build_model(p)
    contact = jwb.ContactModel()
    cmd = JTC.constant(vx=VX, body_height=float(heights([robot])[0]))

    def boot(_):
        sim = jwb.whole_body_init(p)
        return sim, locomotion_init(cfg, p, jwb.observe(p, model, sim,
                                                        contact))

    def run(sim, ctrl):
        def step(c, i):
            s, k = c
            obs = jwb.observe(p, model, s, contact)
            command, _, k = locomotion_step(cfg, p, k, obs, cmd,
                                            (i + 1).astype(jnp.float32) * DT)
            s, _ = jwb.whole_body_step(p, model, s, command, contact, DT)
            return (s, k), s.fb.position[2]

        return jax.lax.scan(step, (sim, ctrl), jnp.arange(TICKS))[1]

    sim, ctrl = jax.jit(jax.vmap(boot))(jnp.zeros(1))
    return sim, ctrl, jax.jit(jax.vmap(run))


def _port_heights(robot: str, jsim, jctrl) -> np.ndarray:
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                        LocomotionState)
    from quadruped_tpu_torch.dynamics import floating_base as fb
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.sim import whole_body as wb
    from quadruped_tpu_torch.utils.convert import to_torch

    from fleet_cases import heights

    cfg = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT("cpu"))
    params = named_params(robot, "cpu")
    loop = bench_wb.Loop(
        cfg, params, fb.build_model(params), wb.ContactModel(),
        TwistCommand.constant(vx=np.asarray([VX]),
                              body_height=heights([robot]), device="cpu"),
        to_torch(jsim, wb.WholeBodySimState, device="cpu"),
        to_torch(jctrl, LocomotionState, device="cpu"))
    _, (h, _) = bench_wb.run(loop, TICKS)
    return h.numpy()


def test_lite2_loop_within_jax_spread_without_bf16_inverse(monkeypatch):
    """With the same float64 inverse in both packages, the Lite2's 40-tick
    loop from JAX's boot parts from JAX's by no more than SPREAD_MULTIPLE
    times JAX's own spread from a start one float32 step away in a joint
    angle."""
    import jax.numpy as jnp

    _patch_exact_inverse(monkeypatch)
    jsim, jctrl, run = _jax_loop("lite2")
    want = np.asarray(run(jsim, jctrl))
    q = np.array(jsim.fb.q)
    q[0, 1] = np.nextafter(q[0, 1], np.float32(9.0))
    nudged = np.asarray(run(jsim.replace(fb=jsim.fb.replace(
        q=jnp.asarray(q))), jctrl))
    spread = np.abs(nudged - want).max()
    got = _port_heights("lite2", jsim, jctrl)
    assert spread > 0.0
    assert np.abs(got - want).max() <= SPREAD_MULTIPLE * spread, \
        (np.abs(got - want).max(), spread)


def test_solve_takes_m_inv_as_jax_does(monkeypatch):
    """Given the same (not quite symmetric) Newton-Schulz M^{-1}, the
    port's solve equals the JAX solve to float32 rounding: K1 is given
    M^{-1} transposed, so its mat-vec is the JAX `solve`'s M^{-1} rhs.
    Contracting over the other index would part by ~the asymmetry times
    the ADMM's amplification (the transposed inverse is checked to move
    the solve by far more)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.solvers import cone_qp as jcq
    from quadruped_tpu_torch.solvers import cone_qp as tcq
    from test_solver_sp import make_probs

    jprob = make_probs(8, seed=3)
    boot = jcq.solve(jprob, iters=400, alpha=1.6)
    kw = dict(iters=24, alpha=1.0, accel_restart=20)
    inv = np.array(jax.jit(lambda m: jcq.newton_schulz_inverse(
        m, jcq.NS_ITERS, 1))(_jax_m(jprob, jcq)))
    asym = np.abs(inv - np.swapaxes(inv, 1, 2)).max() / np.abs(inv).max()
    assert asym > 1e-6
    given = {"m": inv}
    monkeypatch.setattr(jcq, "newton_schulz_inverse", lambda m, *a, **k:
                        jnp.asarray(given["m"]))
    monkeypatch.setattr(tcq, "newton_schulz_inverse", lambda m, *a, **k:
                        torch.from_numpy(given["m"]))
    want = np.asarray(jax.jit(lambda p, x, y: jcq.solve(
        p, x0=x, y0=y, **kw).x)(jprob, boot.x, boot.y))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    prob = tcq.ConeQP(p=t(jprob.p), q=t(jprob.q), mu=torch.full((8,), 0.45),
                      fz_lo=t(jprob.fz_lo), fz_hi=t(jprob.fz_hi))
    got = tcq.solve(prob, x0=t(boot.x), y0=t(boot.y), **kw).x.numpy()
    err = np.abs(got - want).max()
    assert err < 2e-3, err
    given["m"] = np.ascontiguousarray(np.swapaxes(inv, 1, 2))
    other = tcq.solve(prob, x0=t(boot.x), y0=t(boot.y), **kw).x.numpy()
    assert np.abs(other - want).max() > 10 * err


def _jax_m(jprob, jcq):
    """M = gamma d P d + sigma I + blockdiag(A^T rho A) of the JAX solve
    (its scaling, the default rho), batched."""
    import jax.numpy as jnp

    n = jprob.p.shape[-1]
    t = n // 3
    _, d, _, gamma, fz_lo, fz_hi = jcq._equilibrate_scales(jprob)
    pattern = jcq.cone_pattern(jprob.mu, jnp.float32)
    pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]
    rho_rows = jcq.RHO_CONE * (1.0 + 99.0 * pinned
                               * jnp.asarray([0, 0, 0, 0, 1.0]))
    ata = jnp.einsum("...ir,...tr,...rj->...tij",
                     jnp.swapaxes(pattern, -1, -2), rho_rows, pattern)
    scale = gamma[..., None, None] * d[..., :, None] * d[..., None, :]
    return scale * jprob.p + jcq.SIGMA * jnp.eye(n) + jnp.einsum(
        "...tij,tu->...tiuj", ata, jnp.eye(t)).reshape(
            jprob.p.shape[:-2] + (n, n))
