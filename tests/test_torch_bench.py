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

from card_device import (assert_launches, cuda_device,  # noqa: F401
                         launch_record, launches)
from quadruped_tpu_torch import bench as tbench
from quadruped_tpu_torch.solvers import cone_qp

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


# --- on the card (marker `cuda`) -------------------------------------------

CARD_B = 8192
# The two routes' first-step forces against each other, a fraction of m*g:
# the golden-parity gate (each route is held to its kernel's plain version
# in tests/test_torch_fused_admm.py and _fused_full_solve.py).
ROUTES_TOL = 0.03
# The share of seeded solves whose polish diverged and took the cold
# inverse (`seed_rescue`); a seeded path that leaves the pin flips to the
# rescue (no Woodbury step) holds the forces and fails this.
RESCUE_MAX_SHARE = 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [10, 16])
def test_routes_on_card(cuda_device, horizon):
    """The bench's update at B=8192 through route `loop` (the inverse's
    kernel, then K1) and route `full` (K2): one launch of each of the
    route's kernels an update and no other,
    every output finite, and the two routes' first-step forces within
    ROUTES_TOL m*g of each other."""
    first = {}
    for solver, kernel in (("loop", "fused_admm"),
                           ("full", "fused_full_solve")):
        fn, args, _ = tbench.build_bench(CARD_B, solver, horizon,
                                         device=cuda_device)
        before = launches()
        x, y = fn(*args)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launches().items()}
        want = dict.fromkeys(got, 0)
        want[kernel] = 1
        if solver == "loop":
            want["newton_schulz_inverse"] = 1
        assert got == want
        assert torch.isfinite(x).all() and torch.isfinite(y).all()
        first[solver] = x[:, :12]
    dforce = (first["loop"] - first["full"]).abs().max().item()
    assert dforce <= ROUTES_TOL * MG, dforce / MG


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [10, 16])
def test_seeded_route_on_card(cuda_device, horizon):
    """Route `loop` at B=8192 cold and seeded (`minv_reuse`: the boot's
    inverse carry seeds M^{-1}): one K1 launch an update each and one of
    the inverse's kernel in the cold update (and in a rescue), the seeded
    outputs and carry finite, its first-step forces within TOL (the CPU
    limits against JAX) of the cold update's, and at most
    RESCUE_MAX_SHARE of its polishes rescued."""
    fn_c, args_c, _ = tbench.build_bench(CARD_B, "loop", horizon,
                                         device=cuda_device)
    fn_s, args_s, _ = tbench.build_bench(CARD_B, "loop", horizon,
                                         device=cuda_device, minv_reuse=True)
    asked = dict.fromkeys(("wbc_step", "solve_factored", "sqp_steps"), 0)
    before, rescued = launches(), cone_qp.seeded_inverse.rescued
    x_s, y_s, carry = fn_s(*args_s)
    torch.cuda.synchronize()
    rescued = cone_qp.seeded_inverse.rescued - rescued
    assert_launches(before, asked, k1=1, inverses=int(rescued > 0))
    before = launches()
    x_c, _ = fn_c(*args_c)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=1)
    assert torch.isfinite(x_s).all() and torch.isfinite(y_s).all()
    assert torch.isfinite(carry.m_inv).all()
    dforce = (x_s - x_c)[:, :12].abs().max().item()
    assert dforce <= TOL[horizon] * MG, dforce / MG
    assert rescued <= RESCUE_MAX_SHARE * CARD_B


@pytest.mark.cuda
def test_carried_chain_on_card(cuda_device):
    """40 cadence solves at B=2048 (`bench_problems` 15 ms apart), seeded
    (with the rescue) and cold, and a control (cold with two float32
    polish steps), each against a 400-iteration relaxed solve of the same
    problem: every step finite; the seeded error averaged over the batch
    never more than 1% m*g over the cold one (the JAX
    test_long_chain_no_accumulation's limit, which it applies to one
    scenario; per scenario the chains part by chain noise, as the control
    shows); the pins flip; at most RESCUE_MAX_SHARE of the seeded
    polishes rescued; K1 once a solve, the inverse's kernel once a cold
    inverse (each solve's but the seeded ones', and each rescue's)."""
    from quadruped_tpu_torch.control.mpc import MpcConfig
    from quadruped_tpu_torch.solvers.problems import bench_problems

    batch, steps = 2048, 40
    cfg = MpcConfig()
    warm_kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                   accel_restart=cfg.qp_accel_restart)
    boot_kw = dict(iters=cfg.qp_cold_iters, alpha=cfg.qp_cold_alpha)
    asked = dict.fromkeys(("wbc_step", "solve_factored", "sqp_steps"), 0)
    before, rescued = launches(), cone_qp.seeded_inverse.rescued
    rescues = 0
    excess, flips, starts, carry, pins = [], 0, None, None, None
    for k in range(steps):
        prob, _ = bench_problems(batch, horizon=10, t=k * tbench.CADENCE_S,
                                 device=cuda_device)
        oracle = cone_qp.solve(prob, **boot_kw)
        if k == 0:
            sol, carry = cone_qp.solve(prob, **boot_kw,
                                       return_inv_carry=True)
            sols = {"seeded": sol, "cold": oracle, "control": oracle}
        else:
            sols = {"cold": cone_qp.solve(prob, **warm_kw, **starts["cold"]),
                    "control": cone_qp.solve(prob, **warm_kw,
                                             **starts["control"],
                                             ns_f32_polish=2)}
            before_seed = cone_qp.seeded_inverse.rescued
            sols["seeded"], carry = cone_qp.solve(
                prob, **warm_kw, **starts["seeded"], inv_carry=carry,
                seed_rescue=True, return_inv_carry=True)
            rescues += int(cone_qp.seeded_inverse.rescued > before_seed)
        flips += 0 if pins is None else int((carry.pinned != pins).sum())
        pins = carry.pinned
        starts = {name: dict(x0=sol.x, y0=sol.y)
                  for name, sol in sols.items()}
        for sol in sols.values():
            assert torch.isfinite(sol.x).all() and torch.isfinite(sol.y).all()
        err = {name: (sol.x - oracle.x)[:, :12].abs().amax(dim=1) / MG
               for name, sol in sols.items()}
        excess.append((err["seeded"].mean() - err["cold"].mean()).item())
    rescued = cone_qp.seeded_inverse.rescued - rescued
    # Step 0: boot, oracle; the seeded solves invert M cold only in a
    # rescue.
    assert_launches(before, asked, k1=4 * steps - 2,
                    inverses=3 * steps - 1 + rescues)
    assert max(excess) <= 0.01 and flips > 0, (max(excess), flips)
    assert rescued <= RESCUE_MAX_SHARE * batch * (steps - 1)


@pytest.mark.cuda
def test_dense_condensation_on_card(cuda_device):
    """The dense condensation (`condense.condense_cost`) against the
    structured one on the card, B=2048, H=10: max |diff| / max |value| of
    P and of q within 1e-5 (3e-7 on the CPU at B=256)."""
    from quadruped_tpu_torch.core import se3
    from quadruped_tpu_torch.dynamics import srb
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.solvers import condense, problems

    params = a1_params(cuda_device)
    rpy, feet, x0 = (torch.as_tensor(a, device=cuda_device) for a in
                     problems.bench_states(2048, 0.0,
                                           np.random.default_rng(0)))
    x_des = x0[:, None, :].repeat(1, 10, 1)
    x_des[..., 9] = 0.4
    a_ct, b_ct = srb.srb_continuous(se3.rpy_to_rotmat(rpy),
                                    params.total_inertia, params.total_mass,
                                    feet)
    ad, bd = srb.srb_discretize(a_ct, b_ct, problems.DT_MPC)
    w = torch.tensor(problems.STATE_WEIGHTS, dtype=torch.float32,
                     device=cuda_device)
    p_d, q_d = condense.condense_cost(ad, bd, x0, x_des, w,
                                      problems.FORCE_WEIGHT, 10)
    p_s, q_s = condense.condense_cost_structured(
        a_ct, bd, ad, x0, x_des, w, problems.FORCE_WEIGHT, 10,
        problems.DT_MPC)
    assert ((p_d - p_s).abs().max() / p_s.abs().max()).item() <= 1e-5
    assert ((q_d - q_s).abs().max() / q_s.abs().max()).item() <= 1e-5
