"""A1 advanced-trot demo (port of examples/example_a1_trot.py; the
engine's `example_a1_sim`).

Runs a closed-loop MPC trot in the SRB simulator, one robot, and writes
trace plots. Every MPC solve's ADMM loop is the `fused_admm` kernel on
the card (B=1, n = 12 H, 40 iterations; the 400-iteration boot first).

    python -m quadruped_tpu_torch.examples.example_a1_trot [--steps 1000]
        [--vx 0.4] [--horizon 10] [--out PNG] [--device cpu]
"""

from __future__ import annotations

import argparse
import types

from quadruped_tpu_torch.control import mpc, swing
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim.rollout import rollout_init, rollout_segment
from quadruped_tpu_torch.utils import card, viz
from quadruped_tpu_torch.utils.logging import summarize_rollout

TRACE_KEYS = ("base_height_trace", "vel_trace", "forces_trace")


def config(horizon: int = 10, device=None) -> LocomotionConfig:
    return LocomotionConfig(mpc=mpc.MpcConfig(horizon=horizon, qp_iters=40),
                            swing=swing.SwingConfig(),
                            gait=ADVANCED_TROT(device))


def build(vx: float = 0.4, horizon: int = 10, device=None):
    """(config, params, command, booted rollout carry) of one robot."""
    device = card.resolve(device)
    cfg = config(horizon, device)
    params = a1_params(device)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27, device=device)
    return cfg, params, cmd, rollout_init(cfg, params, 1)


def run(steps: int = 1000, vx: float = 0.4, horizon: int = 10,
        device=None) -> dict:
    """The rollout's traces, one robot: base_height_trace [T], vel_trace
    [T, 3], forces_trace [T, 4, 3], alive [] and the final position [3],
    with `loop`, what `build` returns advanced by the run."""
    device = card.resolve(device)
    cfg, params, cmd, carry = build(vx, horizon, device)
    with common.LoopClock(device) as clock:
        carry, res = rollout_segment(cfg, params, cmd, carry, steps)
    out = {k: getattr(res, k)[0].cpu().numpy() for k in TRACE_KEYS}
    out["alive"] = res.alive[0].cpu().numpy()
    out["position"] = res.sim.position[0].cpu().numpy()
    out["loop"] = (cfg, params, cmd, carry)
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--out", default=common.out_path("a1_trot.png"))
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.steps, args.vx, args.horizon, device)
    # The port's summary and plots read batch-first traces: one scenario.
    res = types.SimpleNamespace(**{k: out[k][None]
                                   for k in ("alive",) + TRACE_KEYS})
    print("summary:", summarize_rollout(res))
    if common.have_matplotlib():
        path = viz.plot_rollout(res, args.out)
        if path:
            print("plots:", path)
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
