"""MPC-update benchmark of the port: full MPC updates per second on one card.

    python -m quadruped_tpu_torch.bench [--horizon 16] [--solver full]
        [--batch 8192] [--chunk 0] [--runs 5] [--reps 20]

Twin of the JAX package's bench.py. One "solve" is the full MPC update:
desired-trajectory build, SRB matrices at the current attitude, exact ZOH,
horizon condensation, move blocking where the configuration has it, the
cone build and the warm-started production solve (24 Fast-ADMM iterations,
restart 20, alpha 1) of the next 15 ms cadence problem on a trot contact
table. The 400-iteration relaxed cold boot on the previous cadence step
runs first, untimed, as `mpc_cold_start` does once per rollout.

Configurations: H=10 at `MpcConfig()` defaults, and H>=12 at
`long_horizon_config` (H=16: move blocking (4, 2), n = 120). Solver routes:
`loop` is `cone_qp.solve` (Newton-Schulz in torch, then the `fused_admm`
kernel), the counterpart of the JAX default; `full` is
`cone_qp.solve_fused_full` (the `fused_full_solve` kernel). The cold boot
runs `cone_qp.solve` on both routes, as the JAX bench does.

`chunk` > 0 runs the batch in slices of `chunk` problems, each slice its
own launches; 0 (the default) runs it whole: eager torch has no
super-linear scheduling cost for a large graph to avoid.

Prints one JSON line: the median rate over `runs` timing runs of `reps`
updates each, its [min, max] band, the analytic FLOPs per solve, and the
card's name and power limit. There is no CPU path: without a CUDA device
`main` fails.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from quadruped_tpu_torch.control.mpc import (MpcConfig, gravity_warm_start,
                                             long_horizon_config)
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import srb
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.solvers import condense, cone_qp
from quadruped_tpu_torch.solvers.problems import (DT_MPC, STATE_WEIGHTS,
                                                  bench_states, trot_table)
from quadruped_tpu_torch.utils import card

CADENCE_S = 0.015   # the MPC re-solves every 15 ms
SOLVERS = ("loop", "full")


def bench_config(horizon: int = 10, move_block=None) -> MpcConfig:
    """H >= 12: `long_horizon_config`, else `MpcConfig`, at `horizon`.
    move_block None keeps the configuration's own ((4, 2) for the long
    horizon, none below); a tuple replaces it (() for no blocking)."""
    kw = {} if move_block is None else {"move_block": tuple(move_block)}
    if horizon >= 12:
        return long_horizon_config(horizon=horizon, **kw)
    return MpcConfig(horizon=horizon, **kw)


def cadence_problem(cfg: MpcConfig, params, rpy, feet, x0, contact):
    """The cone QP of one cadence step (blocked where cfg says so)."""
    h = cfg.horizon
    b = x0.shape[0]
    k = torch.arange(h, dtype=torch.float32, device=x0.device)[:, None]
    drift = torch.zeros(13, dtype=torch.float32, device=x0.device)
    drift[3] = 0.4 * DT_MPC
    x_des = x0[:, None, :] + k[None] * drift
    x_des[..., 9] = 0.4
    a, bm = srb.srb_continuous(se3.rpy_to_rotmat(rpy), params.total_inertia,
                               params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, bm, DT_MPC)
    weights = torch.tensor(STATE_WEIGHTS, dtype=torch.float32,
                           device=x0.device)
    p, q = condense.condense_cost_structured(a, bd, ad, x0, x_des, weights,
                                             cfg.force_weight, h, DT_MPC)
    fz_hi = (contact * params.max_force).reshape(b, h * 4)
    if cfg.move_block:
        groups, n_g = condense.move_block_groups(h, *cfg.move_block)
        p, q, fz_hi = condense.reduce_move_blocking(p, q, fz_hi, groups, n_g,
                                                    h)
    mu = torch.full((b,), 0.45, dtype=torch.float32, device=x0.device)
    return cone_qp.ConeQP(p=p, q=q, mu=mu, fz_lo=torch.zeros_like(fz_hi),
                          fz_hi=fz_hi)


def _inputs(batch: int, t: float, horizon: int, device):
    """(rpy, feet, x0, trot table) of the bench ensemble at time t, drawn
    as the JAX bench draws them (states from seed 0, table from seed 1)."""
    rpy, feet, x0 = bench_states(batch, t, np.random.default_rng(0))
    table = trot_table(batch, t, np.random.default_rng(1), horizon)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (rpy, feet, x0, table))


def build_bench(batch: int, solver: str = "loop", horizon: int = 10,
                move_block=None, chunk: int = 0, device=None):
    """The timed MPC update and its warm arguments: returns (fn, args, cfg)
    with fn(*args) -> (x [B, 12G], y [B, 4G, 5]).

    args are (rpy, feet, x0, contact, x_warm, y_warm): the next cadence
    problem's state and table and the cold boot's solution. The JAX bench's
    flip-aware warm-start shift is off in both of its configurations, so
    the update here has none."""
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")
    cfg = bench_config(horizon, move_block)
    params = a1_params(device)

    def full(rpy, feet, x0, contact, x_warm, y_warm):
        prob = cadence_problem(cfg, params, rpy, feet, x0, contact)
        solve = (cone_qp.solve_fused_full if solver == "full"
                 else cone_qp.solve)
        sol = solve(prob, iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                    accel_restart=cfg.qp_accel_restart, x0=x_warm,
                    y0=y_warm)
        return sol.x, sol.y

    def fn(*args):
        b = args[0].shape[0]
        if chunk > 0 and b % chunk == 0 and b > chunk:
            outs = [full(*(a[i:i + chunk] for a in args))
                    for i in range(0, b, chunk)]
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return full(*args)

    # Untimed boot: the relaxed cold solve on the previous cadence step.
    rpy, feet, x0, table = _inputs(batch, 0.0, cfg.horizon, device)
    prob = cadence_problem(cfg, params, rpy, feet, x0, table)
    grav_table = table
    if cfg.move_block:
        grav_table = (prob.fz_hi > 0).float().reshape(batch, -1, 4)
    boot = cone_qp.solve(prob, iters=cfg.qp_cold_iters,
                         alpha=cfg.qp_cold_alpha,
                         x0=gravity_warm_start(params, grav_table))
    args = _inputs(batch, CADENCE_S, cfg.horizon, device) + (boot.x, boot.y)
    return fn, args, cfg


def analytic_flops_per_solve(cfg: MpcConfig, minv_reuse: bool = False
                             ) -> float:
    """Dominant-term FLOP model of one full MPC update (multiply + add = 2
    FLOP): the Newton-Schulz inverse (NS_ITERS steps of two n x n products,
    the majority), the ADMM iterations, M assembly, the structured
    condensation and the equilibration passes. `minv_reuse` (the JAX
    package's cross-cadence seeded inverse) is not ported."""
    if minv_reuse:
        raise NotImplementedError("the seeded inverse (InverseCarry) is not "
                                  "ported")
    g = cfg.n_force_groups
    n = 12 * g
    t = 4 * g
    h = cfg.horizon
    ns = cone_qp.NS_ITERS * 2 * 2 * n ** 3
    admm = cfg.qp_iters * (2 * n * n + 2 * 2 * t * 5 * 3)
    m_assembly = 2 * n * n
    cond = 2 * 4 * h * h * 144 + 4 * 2 * 144 * 13
    equil = 3 * n * n
    return float(ns + admm + m_assembly + cond + equil)


def update_rates(fn, args, batch: int, reps: int = 20, runs: int = 5):
    """Solves/s of `runs` timing runs, sorted: host clock around `reps`
    updates that end in a synchronisation, after one untimed update."""

    def sync():
        if args[0].is_cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    rates = []
    for _ in range(max(runs, 1)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        sync()
        rates.append(batch * reps / (time.perf_counter() - t0))
    return sorted(rates)


def measure(batch: int, solver: str = "loop", horizon: int = 10,
            move_block=None, chunk: int = 0, reps: int = 20, runs: int = 5,
            device=None):
    """Returns (median solves/s, [min, max] band, analytic FLOPs per solve,
    cfg) of `update_rates`."""
    fn, args, cfg = build_bench(batch, solver, horizon, move_block, chunk,
                                device)
    rates = update_rates(fn, args, batch, reps, runs)
    return (rates[len(rates) // 2], [rates[0], rates[-1]],
            analytic_flops_per_solve(cfg), cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--solver", choices=SOLVERS, default="loop")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark measures the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rate, band, flops, cfg = measure(a.batch, a.solver, a.horizon,
                                     chunk=a.chunk, reps=a.reps, runs=a.runs,
                                     device=torch.device("cuda"))
    tag = f", moveblock{cfg.move_block}" if cfg.move_block else ""
    if a.chunk > 0 and a.batch % a.chunk == 0 and a.batch > a.chunk:
        tag += f", chunk{a.chunk}"
    print(json.dumps({
        "metric": f"MPC solves/s (H={cfg.horizon}, full build+solve, "
                  f"qp_iters={cfg.qp_iters} warm@cadence, trot table{tag}, "
                  f"batch={a.batch}, {a.solver})",
        "value": rate,
        "unit": "solves/s",
        "band_min": band[0],
        "band_max": band[1],
        "runs": a.runs,
        "flops_per_solve": flops,
        "achieved_tflops": rate * flops / 1e12,
        "card": card.name_and_power_limit(),
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
