"""Times of one checkout of the port on one card, for comparing two checkouts.

    python quadruped_tpu_torch/benchmarks/checkout_times.py [--root DIR]

Imports `quadruped_tpu_torch` from DIR (default: the checkout holding this
file) and prints one JSON line with the card's name and power limit and:
the closed-loop rollout of chip_smoke.py phase 3 (B=2048 A1 scenarios,
production MPC, 18 periods) in ticks/s, two timed runs after a warm-up;
the fused ADMM kernel (K1) on B=2048 and B=8192 H=10 bench problems, warm
(24 Fast-ADMM iterations) and cold (400 relaxed), in ms; and the MPC-update
benchmark's `loop` route at B=8192, H=10, in solves/s (three runs).

To compare two checkouts, unpack the other one (`git archive`) into an
ignored directory and run this script for both in turns in one call on the
card (A, B, B, A): times on two cards or in two calls are not comparable.
There is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BATCH = 2048
PERIODS = 18


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    root = str(Path(ap.parse_args(argv).root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced
    from quadruped_tpu_torch.solvers import cone_qp, fused_admm
    from quadruped_tpu_torch.solvers.problems import bench_problems
    from quadruped_tpu_torch.utils import card

    if not fused_admm.__file__.startswith(root):
        raise RuntimeError(f"imported {fused_admm.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("checkout_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = bench.a1_params(dev)
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(dev))
    rng = np.random.default_rng(0)
    vx = (0.2 + 0.6 * rng.random(BATCH)).astype(np.float32)
    wz = (rng.normal(size=BATCH) * 0.2).astype(np.float32)
    cmd = TwistCommand.constant(vx=vx, wz=wz, device=dev)
    rollout_cadenced(config, params, cmd, 1)
    torch.cuda.synchronize()
    out = {"root": root, "card": card.name_and_power_limit(),
           "rollout_ticks_per_s": []}
    for _ in range(2):
        t0 = time.perf_counter()
        rollout_cadenced(config, params, cmd, PERIODS)
        torch.cuda.synchronize()
        out["rollout_ticks_per_s"].append(
            BATCH * PERIODS * config.mpc.ticks_per_solve
            / (time.perf_counter() - t0))
    for batch in (2048, 8192):
        prob, _ = bench_problems(batch, horizon=10, device=dev)
        args = cone_qp.admm_inputs(prob)[:8]
        for name, kw, reps in [
                ("warm", dict(iters=24, alpha=1.0, accel_restart=20), 20),
                ("cold", dict(iters=400, alpha=1.6, accel_restart=0), 5)]:
            kw = dict(kw, sigma=cone_qp.SIGMA)
            out[f"k1_{name}_ms_b{batch}"] = card.time_ms(
                lambda: fused_admm.fused_admm(*args, **kw), reps)
    fn, args, _ = bench.build_bench(8192, "loop", 10, device=dev)
    out["loop_h10_solves_per_s"] = bench.update_rates(fn, args, 8192,
                                                      reps=10, runs=3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
