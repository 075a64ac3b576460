"""The port's MPC-update benchmark (quadruped_tpu_torch/bench.py) against the
JAX package's bench.py.

`build_bench` of both packages at B=16 draws the same states and trot
tables (numpy, seeds 0 and 1), runs its untimed cold boot, and returns the
timed update and its warm arguments; the update's outputs are compared.
Routes: the port's `loop` (Newton-Schulz in torch, then the fused ADMM
loop) against the JAX default `fused=False`, and the port's `full` (the
fully fused solve) against `fused="full"` (the Pallas kernel in interpret
mode, tile = batch). H=10 and H=16 with move blocking (4, 2), chunk 0;
route `loop` also with the seeded inverse (`minv_reuse`, the boot's carry
into the update) at both horizons and on the all-stance table at H=10.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch import bench as tbench

B = 16
MG = 13.0 * 9.81
# (horizon, solver, minv_reuse, table)
CASES = [(10, "loop", False, "trot"), (10, "full", False, "trot"),
         (16, "loop", False, "trot"), (16, "full", False, "trot"),
         (10, "loop", True, "trot"), (16, "loop", True, "trot"),
         (10, "loop", False, "stance")]
IDS = [f"h{h}-{s}" + ("-minv_reuse" if m else "")
       + ("" if t == "trot" else f"-{t}") for h, s, m, t in CASES]


def _jax_bench(horizon, solver, minv_reuse, table, monkeypatch):
    import bench as jbench

    monkeypatch.setenv("QTPU_BENCH_FUSED_TILE", str(B))
    monkeypatch.setenv("QTPU_BENCH_MINV_REUSE", "1" if minv_reuse else "0")
    move_block = (4, 2) if horizon == 16 else ()
    fn, args, cfg = jbench.build_bench(
        B, "full" if solver == "full" else False, table,
        move_block=move_block, horizon=horizon, chunk=0, ns_f32_polish=1,
        minv_reuse=minv_reuse)
    return fn(*args), args, cfg


# Tolerance on forces (fraction of m*g) and duals (fraction of their scale).
# Both packages solve at the production single polish step, whose inverses
# differ at ~1e-4 between implementations; 400 relaxed cold iterations and
# 24 warm ones amplify that. Measured on CPU: H=10 (force weight 4e-6, the
# worse conditioned) boot 1.8%, update 1.3% m*g, duals 1.5%: held to the
# golden-parity gate, 3%. H=16 (force weight 1e-4): boot 0.14%, update
# 0.10% m*g, duals 0.3%: held to 1%. The seeded update (minv_reuse) 1.3%
# at H=10, 0.09% at H=16; the all-stance table at H=10: boot 2.7%, update
# 1.8% m*g.
TOL = {10: 0.03, 16: 0.01}


@pytest.mark.parametrize("horizon,solver,minv_reuse,table", CASES, ids=IDS)
def test_update_matches_jax(horizon, solver, minv_reuse, table, monkeypatch):
    """Inputs exactly; the cold boot's solution, the timed update's forces
    and its duals within TOL; with minv_reuse the carry the update takes
    (the boot's inverse to 1e-3 relative, the Newton-Schulz tolerance of
    tests/test_torch_cone_qp.py; its scales and pins to 1e-6) and the one
    it returns (pins and rho exactly)."""
    jout, jargs, jcfg = _jax_bench(horizon, solver, minv_reuse, table,
                                   monkeypatch)
    fn, args, cfg = tbench.build_bench(B, solver, horizon, device="cpu",
                                       minv_reuse=minv_reuse,
                                       table_kind=table)
    assert cfg.move_block == jcfg.move_block
    assert cfg.n_force_groups == jcfg.n_force_groups == 10
    for got, want in zip(args[:4], jargs[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tol = TOL[horizon]
    np.testing.assert_allclose(args[4].numpy(), np.asarray(jargs[4]),
                               atol=tol * MG)
    out = fn(*args)
    assert len(out) == len(jout) == (3 if minv_reuse else 2)
    if minv_reuse:
        _carries_match(args[6], jargs[7])
        _carries_match(out[2], jout[2])
    (x, y), (jx, jy) = out[:2], jout[:2]
    assert x.shape == (B, 120) and y.shape == (B, 40, 5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=tol * MG)
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy,
                               atol=tol * float(np.max(np.abs(jy))))


def _carries_match(carry, jcarry):
    inv, jinv = carry.m_inv.numpy(), np.asarray(jcarry.m_inv)
    assert np.abs(inv - jinv).max() / np.abs(jinv).max() < 1e-3
    for name in ("d_t", "gamma", "pinned", "rho"):
        np.testing.assert_allclose(getattr(carry, name).numpy(),
                                   np.asarray(getattr(jcarry, name)),
                                   rtol=1e-6, err_msg=name)


def test_chunked_matches_monolithic():
    """Chunking only slices the batch: 4 chunks of 4 against the whole
    batch, to float32 roundoff of the batched products (1e-3 N)."""
    fn_c, args, _ = tbench.build_bench(B, "loop", 10, chunk=4, device="cpu")
    fn_m, _, _ = tbench.build_bench(B, "loop", 10, chunk=0, device="cpu")
    xc, _ = fn_c(*args)
    xm, _ = fn_m(*args)
    assert float((xc - xm).abs().max()) < 1e-3


def test_chunked_carry_matches_monolithic():
    """With minv_reuse the chunks slice the carry too and the outputs are
    joined back into one carry: 4 chunks of 4 against the whole batch,
    forces to 1e-3 N and the returned inverses to 1e-5 relative."""
    fn_c, args, _ = tbench.build_bench(B, "loop", 10, chunk=4, device="cpu",
                                       minv_reuse=True)
    fn_m, _, _ = tbench.build_bench(B, "loop", 10, chunk=0, device="cpu",
                                    minv_reuse=True)
    xc, _, cc = fn_c(*args)
    xm, _, cm = fn_m(*args)
    assert float((xc - xm).abs().max()) < 1e-3
    assert isinstance(cc, type(cm)) and cc.m_inv.shape == cm.m_inv.shape
    assert float((cc.m_inv - cm.m_inv).abs().max()
                 / cm.m_inv.abs().max()) < 1e-5
    assert torch.equal(cc.pinned, cm.pinned) and torch.equal(cc.rho, cm.rho)


def test_flop_model_and_configurations(monkeypatch):
    """The FLOP model equals the JAX one, cold and with `minv_reuse` (the
    JAX bench reads its module flag MINV_REUSE, patched here). move_block
    None keeps the configuration's own, () unblocks: H=16 unblocked is
    n = 192, which the fused solve refuses (it pads M to 128, as the Pallas
    kernel does); route `full` refuses minv_reuse, and an unknown table
    raises."""
    import bench as jbench
    from quadruped_tpu.control.mpc import MpcConfig, long_horizon_config

    for horizon, move_block in [(10, ()), (16, (4, 2))]:
        cfg = tbench.bench_config(horizon)
        assert cfg.move_block == move_block
        jcfg = (long_horizon_config() if horizon == 16
                else MpcConfig(horizon=horizon))
        assert tbench.analytic_flops_per_solve(cfg) == \
            jbench.analytic_flops_per_solve(jcfg)
        with monkeypatch.context() as mp:
            mp.setattr(jbench, "MINV_REUSE", True)
            assert tbench.analytic_flops_per_solve(cfg, minv_reuse=True) == \
                jbench.analytic_flops_per_solve(jcfg)
    with pytest.raises(ValueError, match="minv_reuse"):
        tbench.build_bench(2, "full", 10, device="cpu", minv_reuse=True)
    with pytest.raises(ValueError, match="table"):
        tbench.build_bench(2, "loop", 10, device="cpu", table_kind="walk")
    fn, args, cfg = tbench.build_bench(2, "full", 16, move_block=(),
                                       device="cpu")
    assert cfg.n_force_groups == 16
    with pytest.raises(ValueError, match="n <= 128"):
        fn(*args)
    with pytest.raises(ValueError, match="solver"):
        tbench.build_bench(2, "xla", 10, device="cpu")
