"""The full stack on the 18-DoF physics sim: sit -> FSM stand-up ->
advanced trot on the estimators (port of
examples/example_whole_body_standup.py; the engine's `example_a1_real`
minus the UDP bridge).

One A1 boots sitting (base at 0.15 m, the sit-down joint angles); the
robot runner (`exec/runner.py`: the estimation container on raw sensors,
the FSM's STAND_UP ramp into LOCOMOTION, the advanced-trot MPC at
`MpcConfig(horizon=5, qp_iters=40)`) drives the whole-body sim through
the sensor model of `benchmarks/runner.py` without noise. The MPC solves'
ADMM loop is the `fused_admm` kernel on the card (B=1, n=60): the boot's
cold start, then one a solve once the trot starts; the STAND_UP ramp
solves none (the runner skips the idle locomotion step).

    python -m quadruped_tpu_torch.examples.example_whole_body_standup
        [steps] [vx] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.control import mpc, swing
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.estimation.container import EstimatorConfig
from quadruped_tpu_torch.estimation.velocity import VelocityEstimatorConfig
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.exec import RunnerConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.utils import card

STEPS, VX = 3500, 0.2


def config(device) -> RunnerConfig:
    return RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
            swing=swing.SwingConfig(), gait=ADVANCED_TROT(device)),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=True)


def run(steps: int = STEPS, vx: float = VX, device=None) -> dict:
    """One robot's traces: the base position after each tick [T, 3] and
    the FSM state [T]."""
    device = card.resolve(device)
    loop = bench_runner.build(1, device, noise=0.0, vx=vx,
                              config=config(device))
    noise = torch.zeros(steps, 1, bench_runner.NOISE_DIM, device=device)
    with common.LoopClock(device) as clock:
        _, tr = bench_runner.run(loop, steps, noise=noise, record=True)
    out = {"position": tr["position"][0].cpu().numpy(),
           "fsm": tr["fsm"][0].cpu().numpy()}
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    ap.add_argument("vx", nargs="?", type=float, default=VX)
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.steps, args.vx, device)
    pos, fsm = out["position"], out["fsm"]
    for k in range(0, args.steps, max(args.steps // 10, 1)):
        print(f"t={k * 0.002:5.2f}s fsm={int(fsm[k])} "
              f"pos=({float(pos[k, 0]):+.2f}, {float(pos[k, 1]):+.2f}, "
              f"{float(pos[k, 2]):.3f})")
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
