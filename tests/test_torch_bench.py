"""The port's MPC-update benchmark (quadruped_tpu_torch/bench.py) against the
JAX package's bench.py.

`build_bench` of both packages at B=16 draws the same states and trot
tables (numpy, seeds 0 and 1), runs its untimed cold boot, and returns the
timed update and its warm arguments; the update's outputs are compared.
Routes: the port's `loop` (Newton-Schulz in torch, then the fused ADMM
loop) against the JAX default `fused=False`, and the port's `full` (the
fully fused solve) against `fused="full"` (the Pallas kernel in interpret
mode, tile = batch). H=10 and H=16 with move blocking (4, 2), chunk 0.
"""

import numpy as np
import pytest

from quadruped_tpu_torch import bench as tbench

B = 16
MG = 13.0 * 9.81
CASES = [(10, "loop"), (10, "full"), (16, "loop"), (16, "full")]


def _jax_bench(horizon, solver, monkeypatch):
    import bench as jbench

    monkeypatch.setenv("QTPU_BENCH_FUSED_TILE", str(B))
    move_block = (4, 2) if horizon == 16 else ()
    fn, args, cfg = jbench.build_bench(
        B, "full" if solver == "full" else False, "trot",
        move_block=move_block, horizon=horizon, chunk=0, ns_f32_polish=1,
        minv_reuse=False)
    return fn(*args), args, cfg


# Tolerance on forces (fraction of m*g) and duals (fraction of their scale).
# Both packages solve at the production single polish step, whose inverses
# differ at ~1e-4 between implementations; 400 relaxed cold iterations and
# 24 warm ones amplify that. Measured on CPU: H=10 (force weight 4e-6, the
# worse conditioned) boot 1.8%, update 1.3% m*g, duals 1.5%: held to the
# golden-parity gate, 3%. H=16 (force weight 1e-4): boot 0.14%, update
# 0.10% m*g, duals 0.3%: held to 1%.
TOL = {10: 0.03, 16: 0.01}


@pytest.mark.parametrize("horizon,solver", CASES,
                         ids=[f"h{h}-{s}" for h, s in CASES])
def test_update_matches_jax(horizon, solver, monkeypatch):
    """Inputs exactly; the cold boot's solution, the timed update's forces
    and its duals within TOL."""
    (jx, jy), jargs, jcfg = _jax_bench(horizon, solver, monkeypatch)
    fn, args, cfg = tbench.build_bench(B, solver, horizon)
    assert cfg.move_block == jcfg.move_block
    assert cfg.n_force_groups == jcfg.n_force_groups == 10
    for got, want in zip(args[:4], jargs[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tol = TOL[horizon]
    np.testing.assert_allclose(args[4].numpy(), np.asarray(jargs[4]),
                               atol=tol * MG)
    x, y = fn(*args)
    assert x.shape == (B, 120) and y.shape == (B, 40, 5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=tol * MG)
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy,
                               atol=tol * float(np.max(np.abs(jy))))


def test_chunked_matches_monolithic():
    """Chunking only slices the batch: 4 chunks of 4 against the whole
    batch, to float32 roundoff of the batched products (1e-3 N)."""
    fn_c, args, _ = tbench.build_bench(B, "loop", 10, chunk=4)
    fn_m, _, _ = tbench.build_bench(B, "loop", 10, chunk=0)
    xc, _ = fn_c(*args)
    xm, _ = fn_m(*args)
    assert float((xc - xm).abs().max()) < 1e-3


def test_flop_model_and_configurations():
    """The FLOP model equals the JAX one; `minv_reuse` is a parameter and
    raises (the seeded inverse is not ported). move_block None keeps the
    configuration's own, () unblocks: H=16 unblocked is n = 192, which the
    fused solve refuses."""
    import bench as jbench
    from quadruped_tpu.control.mpc import MpcConfig, long_horizon_config

    for horizon, move_block in [(10, ()), (16, (4, 2))]:
        cfg = tbench.bench_config(horizon)
        assert cfg.move_block == move_block
        jcfg = (long_horizon_config() if horizon == 16
                else MpcConfig(horizon=horizon))
        assert tbench.analytic_flops_per_solve(cfg) == \
            jbench.analytic_flops_per_solve(jcfg)
    with pytest.raises(NotImplementedError):
        tbench.analytic_flops_per_solve(cfg, minv_reuse=True)
    fn, args, cfg = tbench.build_bench(2, "full", 16, move_block=())
    assert cfg.n_force_groups == 16
    with pytest.raises(ValueError, match="shared memory"):
        fn(*args)
    with pytest.raises(ValueError, match="solver"):
        tbench.build_bench(2, "xla", 10)
