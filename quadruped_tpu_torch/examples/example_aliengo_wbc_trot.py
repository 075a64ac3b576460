"""Aliengo advanced trot with the WBC (port of
examples/example_aliengo_wbc_trot.py; the engine's `example_aliengo_sim`
in JOY_ADVANCED_TROT with useWBC: MPC stance forces, then the whole-body
controller refines the torques on its 2-tick cadence).

One robot on the SRB sim; every MPC solve's ADMM loop is the `fused_admm`
kernel on the card (B=1, n=60, 40 iterations).

    python -m quadruped_tpu_torch.examples.example_aliengo_wbc_trot
        [--steps 800] [--vx 0.3] [--no-wbc] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from quadruped_tpu_torch.control import mpc, swing, wbc
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import aliengo_params
from quadruped_tpu_torch.sim.rollout import rollout_init, rollout_segment
from quadruped_tpu_torch.utils import card


def config(no_wbc: bool = False, device=None) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT(device),
        wbc=None if no_wbc else wbc.WbcConfig(), use_wbc=not no_wbc)


def run(steps: int = 800, vx: float = 0.3, no_wbc: bool = False,
        device=None) -> dict:
    """One robot's traces: base_height_trace [T], vel_trace [T, 3],
    forces_trace [T, 4, 3], tau_trace [T, 12], alive [] and the final
    position [3]."""
    device = card.resolve(device)
    params = aliengo_params(device)
    cfg = config(no_wbc, device)
    cmd = TwistCommand.constant(vx=vx, body_height=params.body_height,
                                device=device)
    carry = rollout_init(cfg, params, 1)
    with common.LoopClock(device) as clock:
        _, res = rollout_segment(cfg, params, cmd, carry, steps)
    out = {k: getattr(res, k)[0].cpu().numpy()
           for k in ("base_height_trace", "vel_trace", "forces_trace",
                     "tau_trace")}
    out["alive"] = res.alive[0].cpu().numpy()
    out["position"] = res.sim.position[0].cpu().numpy()
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--no-wbc", action="store_true",
                    help="MPC-only baseline for comparison")
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.steps, args.vx, args.no_wbc, device)
    h, v = out["base_height_trace"], out["vel_trace"]
    label = "MPC-only" if args.no_wbc else "MPC+WBC"
    print(f"[{label}] alive={float(out['alive']):.0f} "
          f"final pos={np.round(out['position'], 3)}")
    print(f"height band [{h.min():.3f}, {h.max():.3f}] m; "
          f"mean vx (last half) = {v[len(v) // 2:, 0].mean():+.3f} "
          f"(command {args.vx:+.2f})")
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
