"""Render a trotting A1 to an animated 3-D GIF (port of
examples/example_viz3d.py; the xpp/RViz analogue).

Runs a 2 s whole-body advanced trot (the closed loop of
`benchmarks/whole_body.py` at `MpcConfig(horizon=5, qp_iters=24,
qp_cold_iters=120)`, vx 0.3 m/s; every MPC solve's ADMM loop is the
`fused_admm` kernel on the card, B=1, n=60), records the base pose, joint
angles and contact flags each tick, and writes an animated skeleton GIF
and a three-panel snapshot.

    python -m quadruped_tpu_torch.examples.example_viz3d [out.gif] [steps]
        [--device cpu]
"""

from __future__ import annotations

import argparse

from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
from quadruped_tpu_torch.control import mpc, swing
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.utils import card

STEPS = 1000


def config(device) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT(device))


def build(device=None) -> bench_wb.Loop:
    """One A1 standing on the whole-body sim with its controller booted."""
    device = card.resolve(device)
    return bench_wb.build(1, device, config(device), vx=[0.3])


def run(steps: int = STEPS, device=None) -> dict:
    """One robot's pose after each tick: position [T, 3], rpy [T, 3], q
    [T, 12] and the contact flags [T, 4], with `loop`, what `build`
    returns advanced by the run."""
    device = card.resolve(device)
    loop = build(device)
    rec, on_tick = common.pose_recorder(steps)
    with common.LoopClock(device) as clock:
        loop, _ = bench_wb.run(loop, steps, on_tick=on_tick)
    out = rec.numpy()
    out["loop"] = loop
    return common.timed(out, steps, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=common.out_path("trot3d.gif"))
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.steps, device)
    if common.have_matplotlib():
        print(common.render3d(a1_params("cpu"), out, args.out, every=20,
                              fps=12))
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
