"""Each kernel of the port alone on the card: its time, its plain version's,
and the least time the card could take, at the shapes the main path hands
it. One JSON line a reading, the card's name and power limit first:

    PYTHONPATH=$PWD python -m quadruped_tpu_torch.benchmarks.kernels

* K1 (`solvers/fused_admm.py`) on `bench_problems` at the batches,
  horizons and iterations of its callers (the closed loop's boot and warm
  solve, the bench's update, the fleet's, the hil tick's and the
  examples'), from the bf16 head's z0, and the boot at unblocked H=16;
* K2 (`solvers/fused_full_solve.py`) on the bench's problems at B=2048 and
  8192, with its inverse stage alone and `torch.linalg.inv` of the same M
  as a yardstick the port never calls;
* the dense-QP kernel (`solvers/qp.py::admm_solve`) on the WBC's QPs at
  the Aliengo sweep's batch.

K3's readings are `benchmarks/mxu_rate.py`'s. The tests hold each kernel
to its plain version (tests/test_torch_fused_admm.py, _fused_full_solve.py,
_qp_kernel.py); this module only times them.
"""

from __future__ import annotations

import argparse
import json

import torch

from quadruped_tpu_torch.utils import card

# Peaks of one H100 SXM (NVIDIA data sheet, dense): device memory bytes/s
# and operations/s by type (bf16 on the tensor cores, float32 off them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# K1's shapes: (what, batch, horizon, iterations, alpha, accel_restart).
K1_SHAPES = (("warm solve", 2048, 10, 24, 1.0, 20),
             ("boot", 2048, 10, 400, 1.6, 0),
             ("bench update", 8192, 10, 24, 1.0, 20),
             ("fleet warm solve", 2048, 5, 30, 1.0, 20),
             ("whole-body fleet warm solve", 1024, 10, 24, 1.0, 20),
             ("hil tick", 1, 10, 24, 1.0, 20),
             ("hil tick", 16, 10, 24, 1.0, 20),
             ("dry run", 2, 10, 24, 1.0, 20),
             ("example a1_trot", 1, 10, 40, 1.0, 20),
             ("example aliengo_wbc_trot", 1, 5, 40, 1.0, 20))
DENSE_QP_BATCH = 131072


def bound(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over the memory rate and the sum of operations over
    the peak rate of their type."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = sum(count / PEAK_OPS_PER_S[kind] for kind, count in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def admm_work(batch: int, n: int, iters: int) -> tuple[float, dict]:
    """(bytes, ops) of one ADMM kernel launch on B problems of n variables:
    the n x n matrix, q, mu, lo, hi, rho, x0, y0 read once, x and y written
    once (float32); per iteration the mat-vec (2 n^2), A x and A^T w (4 m)
    and the z, y and x updates (12 m + 4 n)."""
    m = 5 * n // 3
    floats = n * n + 3 * n + 1 + 5 * m
    ops = iters * (2 * n * n + 16 * m + 4 * n)
    return 4.0 * batch * floats, {"f32": float(batch * ops)}


def newton_schulz_ops(batch: int, n: int, ns_bf16: int, ns_f32: int) -> dict:
    """bf16 tensor-core operations of the inverse: two n x n products a
    step, one pass each in the bf16 steps and three in the 3-pass polish."""
    return {"bf16": float(batch * (2 * ns_bf16 + 6 * ns_f32) * 2 * n ** 3)}


def dense_qp_work(batch: int, n: int, m: int,
                  iters: int) -> tuple[float, dict]:
    """(bytes, ops) of one dense-QP launch (`qp.admm_solve`, scaled): P, A,
    q, l and u read once a problem, x, z, y and the two residuals written
    once (float32); ten Ruiz passes (3 n^2 + 4 m n), M (2 m n^2 + m n), the
    inverse (the Schur seed ~n^3, the guard's and two Newton steps' five
    n x n products, the scalings: 11 n^3 + 6 n^2), the iterations (three
    mat-vecs 4 m n + 2 n^2, the updates 6 n + 11 m) and the residuals
    (4 m n + 2 n^2)."""
    floats = (n * n + m * n + n + 2 * m) + (n + 2 * m + 2)
    ops = (10 * (3 * n * n + 4 * m * n) + 2 * m * n * n + m * n
           + 11 * n ** 3 + 6 * n * n
           + iters * (4 * m * n + 2 * n * n + 6 * n + 11 * m)
           + 4 * m * n + 2 * n * n)
    return 4.0 * batch * floats, {"f32": float(batch * ops)}


def device_ms(fn, reps: int = 50) -> float:
    """Device time in ms of one call of fn() among `reps` back to back,
    with the host's work taken out: a sleep kernel holds the stream while
    the host enqueues every call, so the events time the kernels alone
    (where a call costs the host more than its kernel takes, as at a batch
    of a few problems). A plain version's calls outlast the hold, so its
    time also counts the host's enqueueing of its many launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~25 ms of SM clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reading(kernel: str, shape: str, fn, plain, work, **extra) -> dict:
    """One line: the kernel's device time, its plain version's, its bound
    and the share of it."""
    ms = device_ms(fn)
    b_ms, b_by = bound(*work)
    return dict(kernel=kernel, shape=shape, ms=ms,
                plain_ms=device_ms(plain, 3), bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms, **extra)


def k1_readings(dev) -> list:
    from quadruped_tpu_torch.solvers import cone_qp, fused_admm, problems

    out = []
    for what, batch, horizon, iters, alpha, restart in K1_SHAPES:
        prob, _ = problems.bench_problems(batch, horizon=horizon, device=dev)
        inp = cone_qp.admm_inputs(prob)
        kw = dict(iters=iters, sigma=cone_qp.SIGMA, alpha=alpha,
                  accel_restart=restart)
        args = inp[:8]
        n = args[1].shape[1]
        out.append(reading(
            "fused_admm", f"{what}: B={batch}, n={n}, {iters} it.",
            lambda: fused_admm.fused_admm(*args, **kw),
            lambda: fused_admm.fused_admm_reference(*args, **kw),
            admm_work(batch, n, iters)))
        if what == "warm solve":
            x, z, y = cone_qp.bf16_head(inp, 4, cone_qp.SIGMA, cone_qp.ALPHA)
            z_args = (*inp[:6], x, y)
            z_kw = dict(iters=20, sigma=cone_qp.SIGMA, alpha=cone_qp.ALPHA)
            out.append(reading(
                "fused_admm", f"from the bf16 head's z0: B={batch}, n={n}, "
                              f"20 it.",
                lambda: fused_admm.fused_admm(*z_args, **z_kw, z0=z),
                lambda: fused_admm.fused_admm_reference(*z_args, **z_kw,
                                                        z0=z),
                admm_work(batch, n, 20), ms_no_z0=device_ms(
                    lambda: fused_admm.fused_admm(*z_args, **z_kw))))
    prob, x0, cfg = problems.boot_problems(2048, horizon=16, device=dev)
    args = cone_qp.admm_inputs(prob, x0=x0, y0=torch.zeros(
        2048, 64, 5, device=dev))[:8]
    kw = dict(iters=cfg.qp_cold_iters, sigma=cone_qp.SIGMA,
              alpha=cfg.qp_cold_alpha, accel_restart=0)
    out.append(reading(
        "fused_admm", "boot at unblocked H=16: B=2048, n=192, 400 it.",
        lambda: fused_admm.fused_admm(*args, **kw),
        lambda: fused_admm.fused_admm_reference(*args, **kw),
        admm_work(2048, 192, kw["iters"])))
    return out


def k2_readings(dev) -> list:
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.solvers import cone_qp, fused_full_solve

    out = []
    for batch in (2048, 8192):
        fn, args, cfg = bench.build_bench(batch, "full", 10, device=dev)
        prob = bench.cadence_problem(cfg, bench.a1_params(dev), *args[:4])
        m_mat, inp = cone_qp.admm_operands(prob, cone_qp.RHO_CONE,
                                           cone_qp.SIGMA, *args[4:6])
        ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0)
        kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                  accel_restart=cfg.qp_accel_restart, sigma=cone_qp.SIGMA,
                  ns_iters=cone_qp.NS_ITERS, ns_f32_polish=1)
        n = ops[1].shape[1]
        ns = newton_schulz_ops(batch, n, kw["ns_iters"] - 1, 1)
        nbytes, admm_ops = admm_work(batch, n, kw["iters"])
        out.append(reading(
            "fused_full_solve", f"bench update: B={batch}, n={n}, "
                                f"{kw['iters']} it.",
            lambda: fused_full_solve.fused_full_solve(*ops, **kw),
            lambda: fused_full_solve.fused_full_solve_reference(*ops, **kw),
            (nbytes, dict(ns, **admm_ops)),
            inverse_ms=device_ms(lambda: fused_full_solve.fused_full_solve(
                *ops, **dict(kw, iters=0)), 10),
            linalg_inv_ms=device_ms(lambda: torch.linalg.inv(m_mat), 10)))
    return out


def dense_qp_readings(dev) -> list:
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
    from quadruped_tpu_torch.solvers import qp

    args, kw = bench_wbc.qp_problems(DENSE_QP_BATCH, dev)
    b, n = args[1].shape
    m = args[3].shape[-1]
    return [reading("dense_qp", f"the WBC's QPs: B={b}, n={n}, m={m}, "
                                f"{kw['iters']} it.",
                    lambda: qp.admm_solve(*args, **kw),
                    lambda: qp.admm_solve_reference(*args, **kw),
                    dense_qp_work(b, n, m, kw["iters"]))]


def readings():
    """Every reading, one dict a kernel and shape, the card's line first
    (its name and power limit, torch and CUDA); TF32 off for every float32
    product. Raises without a card."""
    if not torch.cuda.is_available():
        raise SystemExit("kernels: no CUDA device; the kernels run only on "
                         "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    yield {"card": card.name_and_power_limit(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    for rows in (k1_readings, k2_readings, dense_qp_readings):
        yield from rows(dev)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    for row in readings():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
