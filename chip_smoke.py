"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  0. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 off for every float32 product;
  1. build: the three kernels of quadruped_tpu_torch/csrc, one nvcc each,
     all started together;
  2. fused_admm vs plain: the ADMM-loop kernel against its plain torch
     version on B=2048 H=10 MPC problems (the JAX solver benchmark's state
     and trot-table distribution), in the 400-iteration relaxed boot scheme
     and the 24-iteration warm Fast-ADMM scheme, with times of both;
  3. the closed loop: `rollout_cadenced` for B=2048 A1 scenarios at the
     production MPC configuration, 18 MPC periods, commands
     vx ~ U(0.2, 0.8), wz ~ N(0, 0.2); fused_admm must be launched once per
     solve (1 boot + 18 periods), every state finite, and at least 99% of
     scenarios alive;
  4. fixture: the 4-scenario production-config rollout against the JAX
     package's output checked in at tests/data/rollout_cadenced_a1_h10.npz;
  5. fused_full_solve vs plain: the Newton-Schulz + ADMM kernel against its
     plain version at B=2048, n=120, H=10 and H=16 (move blocking (4, 2)),
     in both schemes: unscaled forces, the inverse's residual max|I - MX|,
     times of both;
  6. unrolled_dots vs plain: the chained-product kernel against its plain
     version, bf16 and float32, B=1024, 10 products, then the benchmark
     `mxu_rate.measure` through it;
  7. the MPC-update benchmark: `bench.build_bench` at B=8192 for H=10 and
     H=16 through the routes `loop` (fused_admm) and `full`
     (fused_full_solve): one kernel launch per update, the route's kernel
     against its plain version on the operands of that update (the limits
     of phases 2 and 5), solves/s, and the first-step forces of the two
     routes within 3% m*g of each other.
The last two lines are a JSON object describing the kernels and the
device JSON object. There is no CPU path: without a CUDA device the script
fails before printing a result.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "rollout_cadenced_a1_h10.npz"
BATCH = 2048
N_PERIODS = 18
# Kernel vs plain: max |diff| <= ATOL + RTOL |plain| on the scaled iterates.
# The two differ only in the mat-vec summation order (four FMA chains in
# the kernel, cuBLAS's order in the plain version).
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 1e-4
# Card vs the JAX fixture (same numbers as tests/test_torch_rollout.py:
# about 10x the port-vs-JAX differences measured on CPU).
FIXTURE_TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
               "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
               "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-5}
MG = 13.0 * 9.81
# fused_full_solve vs plain: the two sum the bf16 products of the
# Newton-Schulz steps in other orders, so a rounding tie may fall
# differently. Unscaled forces within 0.5 N (0.4% m*g); the inverse's
# residual max|I - MX| below 5e-3 for both (one float32 polish step leaves
# ~1e-3 on the hardest of 2048 problems) and within 1e-4 of each other.
FULL_FORCE_ATOL, FULL_RESIDUAL, FULL_RESIDUAL_GAP = 0.5, 5e-3, 1e-4
# unrolled_dots vs plain: after normalisation the entries are <= 1; the
# same exact float32 products summed in another order, 10 times chained.
# float32 as on the CPU (tests/test_torch_mxu_rate.py); bf16 data is cast
# back to bf16 after every product, so a sum near a rounding tie may land
# one bf16 step (2^-8) away and carry on. An f32 chain that rounded to bf16
# would differ by ~2e-3 and fail.
DOTS_ATOL = {"bf16": 1e-2, "f32": 1e-5}
BENCH_BATCH = 8192


def phase(name: str, **values):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "runs only on the card")
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.solvers import (cone_qp, fused_admm,
                                             fused_full_solve)
    from quadruped_tpu_torch.solvers.problems import bench_problems
    from quadruped_tpu_torch.utils import card, cuda_build

    wrappers = {"fused_admm": fused_admm.fused_admm,
                "fused_full_solve": fused_full_solve.fused_full_solve,
                "unrolled_dots": mxu_rate.unrolled_dots}

    def reset_counts():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def counts_after(path: str, kernel: str, expected=None) -> int:
        """The launch counts of the run of `path` since reset_counts(): only
        `kernel` launched, `expected` times (at least once if None)."""
        counts = {name: w.launches for name, w in wrappers.items()}
        n = counts[kernel]
        others = sum(counts.values()) - n
        if others or n == 0 or (expected is not None and n != expected):
            raise RuntimeError(f"{path}: kernel launches {counts}, expected "
                               f"{expected or 'some'} of {kernel} only")
        return n

    def admm_vs_plain(where: str, args, kw) -> tuple[float, float]:
        """fused_admm against its plain version on the same operands, held
        to KERNEL_ATOL / KERNEL_RTOL; returns (max |dx|, max |dy|)."""
        xk, yk = fused_admm.fused_admm(*args, **kw)
        xr, yr = fused_admm.fused_admm_reference(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
            raise RuntimeError(f"fused_admm output not finite ({where})")
        torch.testing.assert_close(xk, xr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        torch.testing.assert_close(yk, yr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        return (xk - xr).abs().max().item(), (yk - yr).abs().max().item()

    def full_vs_plain(where: str, ops, d, kw) -> dict:
        """fused_full_solve against its plain version on the same operands,
        held to the FULL_* limits (forces unscaled by d); returns the
        compared numbers by name."""
        xk, yk, ik = fused_full_solve.fused_full_solve(
            *ops, **kw, return_inverse=True)
        xr, yr, ir = fused_full_solve.fused_full_solve_reference(*ops, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
            raise RuntimeError(f"fused_full_solve output not finite ({where})")
        eye = torch.eye(ops[0].shape[-1], device=dev)
        res_k, res_p = ((eye - torch.bmm(ops[0], inv)).abs().max().item()
                        for inv in (ik, ir))
        dforce = (xk * d - xr * d).abs().max().item()
        if not (res_k < FULL_RESIDUAL and res_p < FULL_RESIDUAL
                and abs(res_k - res_p) <= FULL_RESIDUAL_GAP
                and dforce <= FULL_FORCE_ATOL):
            raise RuntimeError(
                f"fused_full_solve vs plain ({where}): residuals "
                f"{res_k:.3g} / {res_p:.3g}, forces {dforce}")
        return dict(max_abs_dforce_N=dforce,
                    max_abs_dx_scaled=(xk - xr).abs().max().item(),
                    max_abs_dy=(yk - yr).abs().max().item(),
                    residual_kernel=res_k, residual_plain=res_p)

    full_tol = (f"forces {FULL_FORCE_ATOL} N, residual < {FULL_RESIDUAL}, "
                f"gap <= {FULL_RESIDUAL_GAP}")
    admm_tol = f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}"

    # 0. Environment.
    smi = card.name_and_power_limit()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase("env", card=json.dumps(smi), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          tf32=torch.backends.cuda.matmul.allow_tf32)

    # 1. Build, one nvcc per source, all at once.
    t0 = time.perf_counter()
    sources = {"fused_admm": fused_admm.SOURCE,
               "fused_full_solve": fused_full_solve.SOURCE,
               "unrolled_dots": mxu_rate.SOURCE}
    built = cuda_build.build_shared_libraries(
        [(src, name) for name, src in sources.items()])
    seconds = time.perf_counter() - t0
    for name, (_, log) in zip(sources, built):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        phase(f"build:{name}", seconds=f"{seconds:.3f}",
              ptxas=json.dumps(" | ".join(ptxas)))

    # 2. Kernel vs plain on B=2048 production-shaped problems.
    params = a1_params(dev)
    prob, table = bench_problems(BATCH, horizon=10, device=dev)
    cold = cone_qp.admm_inputs(
        prob, x0=mpc_mod.gravity_warm_start(params, table),
        y0=torch.zeros(BATCH, 40, 5, device=dev))
    x_boot, y_boot = fused_admm.fused_admm(
        *cold[:8], iters=400, sigma=cone_qp.SIGMA, alpha=1.6)
    warm = cold._replace(x0=x_boot, y0=y_boot)
    cases = {"cold": (cold, dict(iters=400, alpha=1.6, accel_restart=0)),
             "warm": (warm, dict(iters=24, alpha=1.0, accel_restart=20))}
    timing, max_err = {}, 0.0
    for name, (inp, kw) in cases.items():
        kw = dict(kw, sigma=cone_qp.SIGMA)
        args = inp[:8]
        dx, dy = admm_vs_plain(name, args, kw)
        max_err = max(max_err, dx, dy)
        ms = card.time_ms(lambda: fused_admm.fused_admm(*args, **kw), 20)
        plain_ms = card.time_ms(
            lambda: fused_admm.fused_admm_reference(*args, **kw), 3)
        timing[name] = (ms, plain_ms)
        phase(f"kernel_vs_plain:{name}", batch=BATCH, n=args[1].shape[1],
              iters=kw["iters"], max_abs_dx=dx, max_abs_dy=dy,
              tol=admm_tol, kernel_ms=ms,
              plain_ms=plain_ms)

    # 3. The slice: rollout_cadenced at B=2048 through the kernel.
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(dev))
    rng = np.random.default_rng(0)
    vx = (0.2 + 0.6 * rng.random(BATCH)).astype(np.float32)
    wz = (rng.normal(size=BATCH) * 0.2).astype(np.float32)
    cmd = TwistCommand.constant(vx=vx, wz=wz, device=dev)
    rollout_cadenced(config, params, cmd, 1)      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = rollout_cadenced(config, params, cmd, N_PERIODS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # One launch per solve: 1 boot + N_PERIODS periods.
    launches_slice = counts_after("rollout_cadenced", "fused_admm",
                                  1 + N_PERIODS)
    tensors = [getattr(res.sim, f.name) for f in
               res.sim.__dataclass_fields__.values()]
    tensors += [res.base_height_trace, res.vel_trace]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError("non-finite state in the rollout")
    alive = res.alive.mean().item()
    h = res.sim.position[:, 2]
    ticks = BATCH * N_PERIODS * config.mpc.ticks_per_solve
    phase("slice", batch=BATCH, periods=N_PERIODS,
          kernel_launches=launches_slice,
          alive_fraction=alive, final_height_min=h.min().item(),
          final_height_max=h.max().item(), final_height_std=h.std().item(),
          mean_vx_last=res.vel_trace[:, -1, 0].mean().item(),
          wall_s=wall, ticks_per_s=ticks / wall)
    if alive < 0.99:
        raise RuntimeError(f"alive fraction {alive} < 0.99")

    # 4. The JAX fixture, on the card.
    want = dict(np.load(FIXTURE))
    fres = rollout_cadenced(config, params, TwistCommand.constant(
        vx=want["vx"], device=dev), int(want["base_height_trace"].shape[1]))
    got = {k: getattr(fres.sim, k).cpu().numpy() for k in FIXTURE_TOL
           if hasattr(fres.sim, k)}
    got["base_height_trace"] = fres.base_height_trace.cpu().numpy()
    got["vel_trace"] = fres.vel_trace.cpu().numpy()
    if not np.array_equal(fres.alive.cpu().numpy(), want["alive"]):
        raise RuntimeError("fixture: alive mask differs")
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in FIXTURE_TOL}
    bad = {k: e for k, e in errs.items() if not e <= FIXTURE_TOL[k]}
    phase("fixture", **{k: f"{e:.3g}/{FIXTURE_TOL[k]:g}"
                        for k, e in errs.items()})
    if bad:
        raise RuntimeError(f"fixture mismatch: {bad}")

    # 5. fused_full_solve vs plain at B=2048, n=120.
    full_timing, full_err = {}, 0.0
    for horizon in (10, 16):
        _, args, cfg = bench.build_bench(BATCH, "loop", horizon, device=dev)
        prob = bench.cadence_problem(cfg, params, *args[:4])
        for name, warm, kw in [
                ("cold", (None, None),
                 dict(iters=400, alpha=1.6, accel_restart=0)),
                ("warm", args[4:6],
                 dict(iters=24, alpha=1.0, accel_restart=20))]:
            m_mat, inp = cone_qp.admm_operands(prob, cone_qp.RHO_CONE,
                                               cone_qp.SIGMA, *warm)
            ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0,
                   inp.y0)
            kw = dict(kw, sigma=cone_qp.SIGMA, ns_iters=cone_qp.NS_ITERS,
                      ns_f32_polish=1)
            held = full_vs_plain(f"H={horizon}, {name}", ops, inp.d, kw)
            full_err = max(full_err, held["max_abs_dforce_N"])
            ms = card.time_ms(
                lambda: fused_full_solve.fused_full_solve(*ops, **kw), 10)
            plain_ms = card.time_ms(
                lambda: fused_full_solve.fused_full_solve_reference(*ops,
                                                                    **kw), 3)
            full_timing[(horizon, name)] = (ms, plain_ms)
            phase(f"full_vs_plain:h{horizon}:{name}", batch=BATCH,
                  n=m_mat.shape[-1], move_block=cfg.move_block,
                  iters=kw["iters"], **held, tol=full_tol, kernel_ms=ms,
                  plain_ms=plain_ms)

    # 6. unrolled_dots vs plain, then the benchmark through the kernel.
    dots_err = {}
    for tag, dtype in mxu_rate.DTYPES.items():
        m = mxu_rate.problems(1024, dtype, dev)
        got = mxu_rate.unrolled_dots(m, 10).float()
        want = mxu_rate.unrolled_dots_reference(m, 10).float()
        torch.cuda.synchronize()
        dots_err[tag] = (got - want).abs().max().item()
        if not dots_err[tag] <= DOTS_ATOL[tag]:
            raise RuntimeError(f"unrolled_dots vs plain ({tag}): "
                               f"{dots_err[tag]} > {DOTS_ATOL[tag]}")
    reset_counts()
    rate = mxu_rate.measure(1024, 10, reps=10, device=dev)
    dots_launches = counts_after("mxu_rate.measure", "unrolled_dots")
    for tag, versions in rate.items():
        phase(f"dots:{tag}", batch=1024, iters=10, max_abs_err=dots_err[tag],
              tol=DOTS_ATOL[tag], launches=dots_launches,
              **{f"{name}_{key}": value for name, (ms, tf) in versions.items()
                 for key, value in (("ms", ms), ("tflops", tf))})

    # 7. The MPC-update benchmark: one counted update per route, its kernel
    # against the plain version on that update's operands, then its rate.
    bench_launches = {"fused_admm": 0, "fused_full_solve": 0}
    bench_timing = {}
    for horizon in (10, 16):
        first_step = {}
        for solver in bench.SOLVERS:
            fn, args, cfg = bench.build_bench(BENCH_BATCH, solver, horizon,
                                              device=dev)
            torch.cuda.synchronize()
            kernel = "fused_admm" if solver == "loop" else "fused_full_solve"
            where = f"bench H={horizon} {solver}"
            reset_counts()
            x, y = fn(*args)
            torch.cuda.synchronize()
            launches = counts_after(where, kernel, 1)
            bench_launches[kernel] += launches
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise RuntimeError(f"{where}: not finite")
            first_step[solver] = x[:, :12]
            # The operands the route's solve hands its kernel.
            prob = bench.cadence_problem(cfg, params, *args[:4])
            kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                      accel_restart=cfg.qp_accel_restart, sigma=cone_qp.SIGMA)
            if solver == "loop":
                ops = cone_qp.admm_inputs(prob, x0=args[4], y0=args[5])[:8]
                dx, dy = admm_vs_plain(where, ops, kw)
                max_err = max(max_err, dx, dy)
                held = dict(max_abs_dx=dx, max_abs_dy=dy, tol=admm_tol)
                run = fused_admm.fused_admm
                run_plain = fused_admm.fused_admm_reference
            else:
                m_mat, inp = cone_qp.admm_operands(
                    prob, cone_qp.RHO_CONE, cone_qp.SIGMA, *args[4:6])
                ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0,
                       inp.y0)
                kw = dict(kw, ns_iters=cone_qp.NS_ITERS, ns_f32_polish=1)
                held = dict(full_vs_plain(where, ops, inp.d, kw),
                            tol=full_tol)
                full_err = max(full_err, held["max_abs_dforce_N"])
                run = fused_full_solve.fused_full_solve
                run_plain = fused_full_solve.fused_full_solve_reference
            ms = card.time_ms(lambda: run(*ops, **kw), 10)
            plain_ms = card.time_ms(lambda: run_plain(*ops, **kw), 3)
            bench_timing[(horizon, kernel)] = (ms, plain_ms)
            rates = bench.update_rates(fn, args, BENCH_BATCH, reps=10,
                                       runs=3)
            phase(f"bench:h{horizon}:{solver}", batch=BENCH_BATCH,
                  n=x.shape[1], move_block=cfg.move_block,
                  kernel_launches=launches, **held, kernel_ms=ms,
                  plain_ms=plain_ms, solves_per_s=rates[len(rates) // 2],
                  band=f"{rates[0]:.1f}-{rates[-1]:.1f}",
                  card=json.dumps(smi))
        dforce = (first_step["loop"] - first_step["full"]).abs().max().item()
        phase(f"bench:h{horizon}:routes", max_first_step_dforce_mg=dforce / MG,
              tol=0.03)
        if not dforce <= 0.03 * MG:
            raise RuntimeError(f"bench H={horizon}: routes differ by "
                               f"{dforce / MG:.4f} m*g")

    print(json.dumps({"kernels": [{
        "name": "fused_admm", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/fused_admm.cu",
        "replaces": "quadruped_tpu/solvers/pallas_admm.py:210",
        "launches": launches_slice, "max_abs_err": max_err,
        "ms": timing["warm"][0], "plain_ms": timing["warm"][1],
        "ms_cold": timing["cold"][0], "plain_ms_cold": timing["cold"][1],
        "launches_bench": bench_launches["fused_admm"],
        "ms_bench": bench_timing[(10, "fused_admm")][0],
        "plain_ms_bench": bench_timing[(10, "fused_admm")][1],
    }, {
        "name": "fused_full_solve", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/fused_full_solve.cu",
        "replaces": "quadruped_tpu/solvers/pallas_admm.py:344",
        "launches": bench_launches["fused_full_solve"],
        "max_abs_err": full_err,
        "ms": full_timing[(10, "warm")][0],
        "plain_ms": full_timing[(10, "warm")][1],
        "ms_cold": full_timing[(10, "cold")][0],
        "plain_ms_cold": full_timing[(10, "cold")][1],
        "ms_bench": bench_timing[(10, "fused_full_solve")][0],
        "plain_ms_bench": bench_timing[(10, "fused_full_solve")][1],
    }, {
        "name": "unrolled_dots", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/unrolled_dots.cu",
        "replaces": "benchmarks/exp_mxu_rate.py:81",
        "launches": dots_launches, "max_abs_err": max(dots_err.values()),
        "ms": rate["bf16"]["kernel"][0], "plain_ms": rate["bf16"]["plain"][0],
        "ms_f32": rate["f32"]["kernel"][0],
        "plain_ms_f32": rate["f32"]["plain"][0],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
