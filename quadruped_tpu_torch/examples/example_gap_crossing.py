"""Cross a gap strip with the walk stack and render it to a 3-D GIF (port
of examples/example_gap_crossing.py).

The statically-stable walk crosses a 6 cm gap on the 18-DoF whole-body
sim, with `planner.foot_stepper.gap_foothold_adjust` coordinating the
footholds (hold at the near edge, cross past the center, pair
coordination): the plum-pile half of the reference's qrFootStepper,
rendered with the terrain wireframe (the gap shows as a trench). The walk
loop of `benchmarks/walk.py` with its gap terrain and hook, the
force-balance QP at its default iterations. No kernel of the port runs.

    python -m quadruped_tpu_torch.examples.example_gap_crossing [out.gif]
        [seconds] [--device cpu]
"""

from __future__ import annotations

import argparse

from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.control.stance_force_balance import \
    ForceBalanceConfig
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.utils import card

DT = bench_walk.DT
SECONDS = 40.0


def build(device=None):
    """One A1 standing before the gap with the walk controller booted."""
    device = card.resolve(device)
    return common.terrain_loop(bench_walk.gap_terrain(),
                               bench_walk.gap_hook(device),
                               ForceBalanceConfig().qp_iters, device)


def run(seconds: float = SECONDS, device=None) -> dict:
    """One robot's pose after each tick: position [T, 3], rpy [T, 3], q
    [T, 12], the contact flags [T, 4] and the legs' sub-states [T, 4],
    with `loop`, what `build` returns advanced by the run."""
    device = card.resolve(device)
    return common.terrain_walk(build(device), int(seconds / DT), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=common.out_path("gap3d.gif"))
    ap.add_argument("seconds", nargs="?", type=float, default=SECONDS)
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    out = run(args.seconds, device)
    pos = out["position"]
    print(f"crossing: x {pos[0, 0]:+.2f} -> {pos[-1, 0]:+.2f} m, "
          f"h band [{pos[:, 2].min():.3f}, {pos[:, 2].max():.3f}] "
          f"(gap {bench_walk.GAP_W} m at x={bench_walk.GAP_X})")
    if common.have_matplotlib():
        print(common.render3d(a1_params("cpu"), out, args.out, every=60,
                              fps=10, terrain=bench_walk.gap_terrain()))
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
