"""MPC-update benchmark of the port: full MPC updates per second on one card.

    python -m quadruped_tpu_torch.bench [--horizon 16] [--solver full]
        [--minv-reuse] [--ns-f32-polish 1] [--table trot|stance]
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

`minv_reuse` (route `loop` only) is the JAX bench's QTPU_BENCH_MINV_REUSE:
the boot returns its inverse carry (`cone_qp.InverseCarry`), and the
timed update takes it, inverts M by `cone_qp.seeded_inverse` instead of
the cold Newton-Schulz inverse and returns (x, y, carry). The update
rescues the scenarios whose seeded polish diverged with the cold inverse
(`seed_rescue`; the JAX bench has no rescue and returns non-finite
forces for them: 1 and 4 of the 8192 problems at H=10 and H=16). The JAX
bench ignores the flag on its fused routes; here route `full` with it
raises.
`ns_f32_polish` sets the timed solve's float32 polish steps and
`table_kind` the contact table: "trot" (half the triples pinned) or
"stance" (all in stance), as the JAX bench's QTPU_BENCH_NS_POLISH and
QTPU_BENCH_TABLE do.

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
                                                  bench_states, stance_table,
                                                  trot_table)
from quadruped_tpu_torch.utils import card, tree

CADENCE_S = 0.015   # the MPC re-solves every 15 ms
SOLVERS = ("loop", "full")
TABLES = ("trot", "stance")


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


def _inputs(batch: int, t: float, horizon: int, device,
            table_kind: str = "trot"):
    """(rpy, feet, x0, contact table) of the bench ensemble at time t,
    drawn as the JAX bench draws them (states from seed 0, the trot table
    from seed 1)."""
    rpy, feet, x0 = bench_states(batch, t, np.random.default_rng(0))
    table = (trot_table(batch, t, np.random.default_rng(1), horizon)
             if table_kind == "trot" else stance_table(batch, horizon))
    return tuple(torch.as_tensor(a, device=device)
                 for a in (rpy, feet, x0, table))


def build_bench(batch: int, solver: str = "loop", horizon: int = 10,
                move_block=None, chunk: int = 0, device=None,
                minv_reuse: bool = False, ns_f32_polish: int = 1,
                table_kind: str = "trot"):
    """The timed MPC update and its warm arguments: returns (fn, args, cfg)
    with fn(*args) -> (x [B, 12G], y [B, 4G, 5]), or with minv_reuse
    (x, y, InverseCarry).

    args are (rpy, feet, x0, contact, x_warm, y_warm): the next cadence
    problem's state and table and the cold boot's solution; with
    minv_reuse the boot's inverse carry follows. The JAX bench's
    flip-aware warm-start shift is off in both of its configurations, so
    the update here has none. Everything lies on the card unless `device`
    says otherwise."""
    device = card.resolve(device)
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")
    if table_kind not in TABLES:
        raise ValueError(f"table {table_kind!r} is not one of {TABLES}")
    if minv_reuse and solver != "loop":
        raise ValueError("minv_reuse runs on route 'loop' only: the fused "
                         "solve inverts M itself and takes no carry")
    cfg = bench_config(horizon, move_block)
    params = a1_params(device)

    def full(rpy, feet, x0, contact, x_warm, y_warm, inv_carry=None):
        prob = cadence_problem(cfg, params, rpy, feet, x0, contact)
        kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                  accel_restart=cfg.qp_accel_restart,
                  ns_f32_polish=ns_f32_polish, x0=x_warm, y0=y_warm)
        if solver == "full":
            sol = cone_qp.solve_fused_full(prob, **kw)
        elif minv_reuse:
            sol, carry = cone_qp.solve(prob, inv_carry=inv_carry,
                                       seed_rescue=True,
                                       return_inv_carry=True, **kw)
            return sol.x, sol.y, carry
        else:
            sol = cone_qp.solve(prob, **kw)
        return sol.x, sol.y

    def fn(*args):
        b = args[0].shape[0]
        if chunk > 0 and b % chunk == 0 and b > chunk:
            outs = [full(*tree.index(args, slice(i, i + chunk)))
                    for i in range(0, b, chunk)]
            columns = zip(*[[v for _, v in tree.leaves(o)] for o in outs])
            return tree.replace_leaves(outs[0],
                                       [torch.cat(c) for c in columns])
        return full(*args)

    # Untimed boot: the relaxed cold solve on the previous cadence step,
    # with its inverse carry.
    rpy, feet, x0, table = _inputs(batch, 0.0, cfg.horizon, device,
                                   table_kind)
    prob = cadence_problem(cfg, params, rpy, feet, x0, table)
    grav_table = table
    if cfg.move_block:
        grav_table = (prob.fz_hi > 0).float().reshape(batch, -1, 4)
    boot, carry = cone_qp.solve(prob, iters=cfg.qp_cold_iters,
                                alpha=cfg.qp_cold_alpha,
                                x0=gravity_warm_start(params, grav_table),
                                return_inv_carry=True)
    args = _inputs(batch, CADENCE_S, cfg.horizon, device, table_kind) \
        + (boot.x, boot.y)
    return fn, args + (carry,) if minv_reuse else args, cfg


def analytic_flops_per_solve(cfg: MpcConfig, minv_reuse: bool = False
                             ) -> float:
    """Dominant-term FLOP model of one full MPC update (multiply + add = 2
    FLOP), the JAX bench's: the inverse (cold: NS_ITERS steps of two n x n
    products, the majority; `minv_reuse`: the seeded inverse's residual
    step, three bf16 and one float32 polish steps and the Woodbury block),
    the ADMM iterations, M assembly, the structured condensation and the
    equilibration passes."""
    g = cfg.n_force_groups
    n = 12 * g
    t = 4 * g
    h = cfg.horizon
    if minv_reuse:
        ns_matmuls = 3 + 2 * (4 - 1) + 2 * 1
        ns = ns_matmuls * 2 * n ** 3 + 2 * n * n * t + t ** 3 + 2 * n * n
    else:
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
            device=None, minv_reuse: bool = False, ns_f32_polish: int = 1,
            table_kind: str = "trot"):
    """Returns (median solves/s, [min, max] band, analytic FLOPs per solve,
    cfg) of `update_rates`, on the card unless `device` says otherwise."""
    device = card.resolve(device)
    fn, args, cfg = build_bench(batch, solver, horizon, move_block, chunk,
                                device, minv_reuse, ns_f32_polish,
                                table_kind)
    rates = update_rates(fn, args, batch, reps, runs)
    return (rates[len(rates) // 2], [rates[0], rates[-1]],
            analytic_flops_per_solve(cfg, minv_reuse), cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--solver", choices=SOLVERS, default="loop")
    ap.add_argument("--minv-reuse", action="store_true")
    ap.add_argument("--ns-f32-polish", type=int, default=1)
    ap.add_argument("--table", choices=TABLES, default="trot")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark measures the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rate, band, flops, cfg = measure(
        a.batch, a.solver, a.horizon, chunk=a.chunk, reps=a.reps,
        runs=a.runs, minv_reuse=a.minv_reuse, ns_f32_polish=a.ns_f32_polish,
        table_kind=a.table)
    tag = f", moveblock{cfg.move_block}" if cfg.move_block else ""
    if a.ns_f32_polish != 1:
        tag += f", ns_f32_polish={a.ns_f32_polish}"
    if a.minv_reuse:
        tag += ", minv_reuse"
    if a.chunk > 0 and a.batch % a.chunk == 0 and a.batch > a.chunk:
        tag += f", chunk{a.chunk}"
    print(json.dumps({
        "metric": f"MPC solves/s (H={cfg.horizon}, full build+solve, "
                  f"qp_iters={cfg.qp_iters} warm@cadence, {a.table} "
                  f"table{tag}, batch={a.batch}, {a.solver})",
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
