"""Multi-process weak scaling of the batched MPC solve.

    python -m quadruped_tpu_torch.benchmarks.scaling [--procs 2]
        [--batch-per-rank 32] [--reps 5] [--device cpu]

Twin of the JAX package's benchmarks/scaling_multiprocess.py. Runs the
same timed solve under one process and under N processes (one rank each,
started through `distributed.runtime.initialize_from_env` from the QTPU_*
variables), the batch per rank held fixed: the JAX bench's problem
distribution (`solvers.problems.bench_problems`, H=10), a 400-iteration
relaxed boot solve for the warm start, then the timed warm solve
(`MpcConfig()`: 24 Fast-ADMM iterations, K1 on the card) of each rank's
rows through `distributed.scaling.sharded_solve_stats`, whose mean |f|
reduces over the mesh. Prints one JSON line: solves/s at 1 and N
processes and the efficiency between them. It writes no file.

One rank per device: the card's machine has one card, so N = 1 there
(NCCL refuses two ranks on one card); N = 2 runs on the CPU with gloo
(`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def worker(batch_per_rank: int, reps: int, device: str | None) -> dict:
    """One rank's part: returns {solves_per_s, processes, stat, rank}."""
    import torch

    from quadruped_tpu_torch.control.mpc import MpcConfig
    from quadruped_tpu_torch.distributed import runtime, shard_batch
    from quadruped_tpu_torch.distributed.scaling import (measure_throughput,
                                                         sharded_solve_stats)
    from quadruped_tpu_torch.solvers import cone_qp, problems
    from quadruped_tpu_torch.utils import card

    dev = card.resolve(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    runtime.initialize_from_env(dev)
    mesh = runtime.global_mesh(device=dev)
    nproc = runtime.process_count()
    cfg = MpcConfig()
    prob, _ = problems.bench_problems(batch_per_rank * nproc, 10,
                                      device="cpu")
    prob = shard_batch(mesh, prob)
    boot = cone_qp.solve(prob, iters=cfg.qp_cold_iters,
                         alpha=cfg.qp_cold_alpha)

    def solve(p):
        sol = cone_qp.solve(p, iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                            accel_restart=cfg.qp_accel_restart, x0=boot.x,
                            y0=boot.y)
        return sol.x[:, :12].reshape(-1, 4, 3)

    fn = sharded_solve_stats(mesh, solve)
    dt = measure_throughput(fn, (prob,), reps)
    _, stat = fn(prob)
    rank = runtime.process_index()
    torch.distributed.destroy_process_group()
    return {"solves_per_s": batch_per_rank * nproc / dt,
            "processes": nproc, "stat": float(stat), "rank": rank}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(n_procs: int, batch_per_rank: int, reps: int,
              device: str | None, timeout: float = 900.0) -> dict:
    """Start n_procs workers on a free port, wait for all, return rank 0's
    result; raises with every worker's output when one fails."""
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        for k in ("QTPU_NUM_PROCESSES", "WORLD_SIZE"):
            env.pop(k, None)
        if n_procs > 1:
            env.update(QTPU_COORDINATOR=f"127.0.0.1:{port}",
                       QTPU_NUM_PROCESSES=str(n_procs),
                       QTPU_PROCESS_ID=str(pid))
        args = [sys.executable, "-m", "quadruped_tpu_torch.benchmarks.scaling",
                "--worker", "--batch-per-rank", str(batch_per_rank),
                "--reps", str(reps)]
        if device:
            args += ["--device", device]
        procs.append(subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("scaling worker failed:\n" + "\n".join(outs))
    for line in outs[0].splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no result line: {outs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--batch-per-rank", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: gloo ranks)")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        res = worker(a.batch_per_rank, a.reps, a.device)
        if res.pop("rank") == 0:
            print(json.dumps(res), flush=True)
        return 0
    one = run_procs(1, a.batch_per_rank, a.reps, a.device)
    many = one if a.procs == 1 else run_procs(a.procs, a.batch_per_rank,
                                              a.reps, a.device)
    cores = os.cpu_count() or 1
    out = {"device": a.device or "cuda", "processes": a.procs,
           "batch_per_rank": a.batch_per_rank,
           "solves_per_s_1proc": one["solves_per_s"],
           f"solves_per_s_{a.procs}proc": many["solves_per_s"],
           "process_scaling_efficiency":
               many["solves_per_s"] / (one["solves_per_s"] * a.procs),
           "host_cores": cores}
    if (a.device or "cuda") != "cpu":
        from quadruped_tpu_torch.utils import card

        out["card"] = card.name_and_power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
