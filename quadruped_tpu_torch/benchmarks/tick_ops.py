"""Torch operator calls per control tick of a locomotion mode, by stage.

    python quadruped_tpu_torch/benchmarks/tick_ops.py [--mode velocity]
        [--batch 8] [--ticks 2] [--device cpu]

Runs a few warm ticks of the mode (none in `walk`), then counts every
torch operator call of `--ticks` more ticks with a dispatch hook, split
into the views (which launch nothing) and the rest, and the rest by stage
(the innermost of the STAGES functions on the stack; `fused_admm` is the
ADMM loop that is one kernel launch on the card). Modes: `rollout` of the A1 in VELOCITY /
POSITION (TROT, ForceBalanceConfig()), ADVANCED_TROT at MpcConfig()
(`advanced_trot`) and the same with the WBC (`wbc`, use_wbc=True); the
whole-body closed loop of benchmarks/whole_body.py (`whole_body`); one
`wbc_step` on the states of benchmarks/wbc.py (`wbc_tick`); the walk bench
of benchmarks/walk.py (`walk`: its first tick, which runs the pose SQP,
counted apart from the `--ticks` that follow, which do not; the SQP's own
calls under `pose_sqp/`); and the ADVANCED_TROT loop with a second gait
table (`transition`, the configuration of the JAX
test_closed_loop_trot_walk_trot); and the robot runner on the whole-body
sim (`runner`, benchmarks/runner.py: one STAND_UP tick from the sitting
boot with the ramp shortcut and one without it, counted apart, then
`--ticks` of the estimated trot from the fixture's trot checkpoint tiled
to the batch); and the heterogeneous fleet of benchmarks/fleet.py
(`fleet`: the A1, Go1, Aliengo and Lite3 at four speeds, stacked
parameters, the 16-scenario grid tiled to `--batch` rounded up to a
multiple of 16). With the MPC cadence of 8 ticks,
`--ticks 8` averages over one whole cycle. Prints one JSON line. A count, not a time: it is the same on the CPU and on the card,
except that on the card some calls launch more than one kernel and the
fused_admm kernel replaces its plain version's calls (chip_smoke.py counts
the kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import stance_force_balance as stance_fb
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control import fsm, wbc
from quadruped_tpu_torch.control.desired_state import ControlMode, TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.core import linalg, splines
from quadruped_tpu_torch.control import walk_locomotion
from quadruped_tpu_torch.exec import runner as exec_runner
from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
from quadruped_tpu_torch.gait.scheduler import _config
from quadruped_tpu_torch.planner import pose_planner
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
from quadruped_tpu_torch.sim import rollout as rollout_mod
from quadruped_tpu_torch.sim import srb_sim, whole_body
from quadruped_tpu_torch.solvers import cone_qp, polish, qp
from quadruped_tpu_torch.utils import card

MODES = ("velocity", "position", "advanced_trot", "wbc", "whole_body",
         "wbc_tick", "walk", "transition", "runner", "fleet")
# (module, function name, stage): innermost stages first in the stack.
STAGES = [(cone_qp, "fused_admm", "fused_admm"),
          (walk_locomotion, "walk_gait_update", "gait"),
          (splines, "swing_parabola", "swing"),
          (linalg, "onesided_jacobi_svd", "jacobi_svd"),
          (qp, "admm_solve", "admm"),
          (polish, "solve_factored", "polish"),
          (stance_fb, "compute_contact_forces", "stance_force_balance"),
          (mpc_mod, "mpc_step", "mpc"),
          (swing_mod, "swing_step", "swing"),
          (srb_sim, "srb_sim_step", "srb_sim"),
          (wbc, "wbc_step", "wbc"),
          (whole_body, "whole_body_step", "whole_body_step"),
          (whole_body, "observe", "whole_body_observe"),
          (pose_planner, "plan_target_pose_sqp", "pose_sqp"),
          (exec_runner, "estimator_update", "estimator"),
          (fsm, "fsm_step", "fsm"),
          (bench_runner, "sensors", "sensors")]


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stage = ["tick"]
        self.views = 0
        self.by_stage: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            self.views += 1
        else:
            key = self.stage[-1]
            if "pose_sqp" in self.stage[:-1]:
                key = "pose_sqp/" + key
            self.by_stage[key] = self.by_stage.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _staged(counter: _Counter):
    """Wrap each STAGES function so that the counter knows the stage."""
    saved = []
    for module, name, stage in STAGES:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _stage=stage, **kw):
            counter.stage.append(_stage)
            try:
                return _fn(*a, **kw)
            finally:
                counter.stage.pop()

        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _advance(mode: str, batch: int, device):
    """A function that runs n more ticks of `mode`, after 3 warm ticks."""
    if mode == "wbc_tick":
        step, args = bench_wbc.build(batch, device)
        step(*args)
        return lambda n: [step(*args) for _ in range(n)]
    if mode == "walk":
        # No warm ticks: the first tick is the one that plans the pose.
        loop = [bench_walk.build(batch, device)]

        def advance(n):
            loop[0], _ = bench_walk.run(loop[0], n)

        return advance
    if mode == "runner":
        trot, _, _ = bench_runner.window_loop(
            np.load(bench_runner.FIXTURE), ("trot",), device)
        loop = [bench_runner.tile(trot, batch, 0.2, 1.0)]

        def advance(n):
            loop[0], _ = bench_runner.run(loop[0], n)

        advance(3)
        return advance
    if mode == "whole_body":
        loop, _ = bench_wb.run(bench_wb.build(batch, device), 3)
        return lambda n: bench_wb.run(loop, n)
    params = a1_params(device)
    cmd = TwistCommand.constant(vx=np.full(batch, 0.2, np.float32),
                                body_height=0.27, device=device)
    if mode == "fleet":
        n = len(bench_fleet.ROBOTS) * len(bench_fleet.VX)
        fleet = bench_fleet.build(-(-batch // n), device)
        config, params, cmd = fleet.config, fleet.params, fleet.cmd
        batch = len(fleet.robots)
    elif mode == "transition":
        config = LocomotionConfig(
            mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
            swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(device),
            gait_b=_config(0.45, 0.75, [0.5, 0.0, 0.75, 0.25],
                           device=device))
    elif mode in ("advanced_trot", "wbc"):
        config = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                                  swing=swing_mod.SwingConfig(),
                                  gait=ADVANCED_TROT(device),
                                  wbc=wbc.WbcConfig(),
                                  use_wbc=mode == "wbc")
    else:
        m = {"velocity": ControlMode.VELOCITY,
             "position": ControlMode.POSITION}[mode]
        config = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                                  swing=swing_mod.SwingConfig(mode=m),
                                  gait=TROT(device), mode=m,
                                  force_balance=stance_fb.ForceBalanceConfig())
    carry = rollout_mod.rollout_init(config, params, batch)
    carry, _ = rollout_mod.rollout_segment(config, params, cmd, carry, 3)
    return lambda n: rollout_mod.rollout_segment(config, params, cmd, carry,
                                                 n)


def _count(advance, ticks: int) -> dict:
    counter = _Counter()
    with _staged(counter), counter:
        advance(ticks)
    by_stage = {k: v / ticks for k, v in counter.by_stage.items()}
    return {"views_per_tick": counter.views / ticks,
            "other_calls_per_tick": sum(by_stage.values()),
            "other_calls_by_stage": by_stage}


def count(mode: str, batch: int, ticks: int, device) -> dict:
    advance = _advance(mode, batch, device)
    out = {"mode": mode, "batch": batch, "ticks": ticks,
           "device": str(device)}
    if mode == "walk":
        out["replan_tick"] = _count(advance, 1)
    if mode == "runner":
        for key, skip in (("ramp_tick", True), ("ramp_tick_no_shortcut",
                                                False)):
            boot = bench_runner.build(batch, device, config=(
                bench_runner.default_config(device, skip)))
            out[key] = _count(lambda n, b=boot: bench_runner.run(b, n), 1)
    return dict(out, **_count(advance, ticks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="velocity")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(count(args.mode, args.batch, args.ticks,
                           card.resolve(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
