"""The port's closed loops on the whole-body simulator at full batch, on
the card (marker `cuda`; skipped without one). Imports no JAX.

* the whole-body trot (benchmarks/whole_body.py, the twin of the JAX
  benchmarks/bench_whole_body.py): B=1024, 300 ticks; and the
  cross-simulator check (the twin of the JAX
  test_whole_body_trot_matches_srb) at B=64, 600 ticks;
* the statically-stable walk (benchmarks/walk.py) at B=256, 320 ticks,
  past the first TRUE_SWING entry (tick 308);
* the robot runner (benchmarks/runner.py) at B=1024: 200 ticks of the
  STAND_UP ramp from the sitting boot on noisy estimates, with and
  without the ramp's shortcut; and 250 ticks from the fixture's
  checkpoint 100 ticks before STAND_UP -> LOCOMOTION.

Each holds at least 99% of scenarios alive, every state finite, K1 once
a batched MPC solve (the boot's included) and no other MPC kernel, and
the dense-QP kernel once a QP its callers asked for (tests/card_device.py).
The fixtures of these loops are held on the card by the `cuda` cases of
the CPU tests (test_torch_whole_body.py, _walk_windows.py, _runner.py).
"""

import math

import numpy as np
import pytest
import torch

from card_device import (assert_launches, count_qps,  # noqa: F401
                         cuda_device, launch_record, launches)
from quadruped_tpu_torch.utils import tree

pytestmark = pytest.mark.cuda

CYCLE = 8          # ticks an MPC period


def _finite(*objs) -> bool:
    return all(bool(torch.isfinite(v).all())
               for o in objs for _, v in tree.leaves(o)
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def test_whole_body_trot(cuda_device, monkeypatch):
    """B=1024, 300 ticks: every alive scenario's final height in
    [0.2, 0.35] m."""
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb

    batch, ticks = 1024, 300
    asked, before = count_qps(monkeypatch), launches()
    loop, _ = bench_wb.run(bench_wb.build(batch, cuda_device), ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=1 + math.ceil(ticks / CYCLE))
    assert _finite(loop.sim.fb)
    alive = bench_wb.alive(loop) > 0.5
    assert alive.float().mean().item() >= 0.99
    h = loop.sim.fb.position[alive, 2]
    assert 0.2 <= h.min().item() and h.max().item() <= 0.35


def test_whole_body_matches_srb(cuda_device):
    """The whole-body loop and the SRB `rollout` at `MpcConfig(horizon=5,
    qp_iters=24, qp_cold_iters=120)`, vx = 0.25, B=64, 600 ticks (the JAX
    test runs 1000): over ticks 400-600 each scenario's mean height within
    3 cm and mean vx within 0.15 m/s; the SRB run all alive."""
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod

    batch, ticks = 64, 600
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(cuda_device))
    srb = rollout_mod.rollout(config, a1_params(cuda_device),
                              TwistCommand.constant(vx=0.25, body_height=0.27,
                                                    batch=batch,
                                                    device=cuda_device),
                              ticks)
    loop = bench_wb.build(batch, cuda_device, config, np.full(batch, 0.25))
    _, (h_wb, vx_wb) = bench_wb.run(loop, ticks)
    win = slice(400, ticks)
    dh = (h_wb[:, win].mean(1)
          - srb.base_height_trace[:, win].mean(1)).abs().max().item()
    dvx = (vx_wb[:, win].mean(1)
           - srb.vel_trace[:, win, 0].mean(1)).abs().max().item()
    assert torch.isfinite(h_wb).all() and srb.alive.min().item() == 1.0
    assert dh < 0.03 and dvx < 0.15, (dh, dvx)


def test_walk(cuda_device, monkeypatch):
    """B=256, 320 ticks: at most one leg in TRUE_SWING a scenario on every
    tick, every leg that left its unload window swung (and some did); no
    MPC kernel; the dense-QP kernel once a tick (the force balance) and
    once a step of each pose SQP, which runs on the replan ticks only."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.gait.walk import SubLegState

    batch, ticks = 256, 320
    loop = bench_walk.build(batch, cuda_device)
    asked, before = count_qps(monkeypatch), launches()
    loop, tr = bench_walk.run(loop, ticks, record=True)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=0)
    assert asked["solve_factored"] == ticks
    assert _finite(loop.sim.fb, loop.walk.liftoff_pos_world,
                   loop.walk.foot_target_world, loop.walk.warm_forces,
                   loop.walk.pose.pose_target,
                   loop.walk.gait.normalized_phase, tr["position"],
                   tr["forces"], tr["q_cmd"])
    sub = tr["sub_state"].cpu().numpy()                      # [B, T, 4]
    swinging = sub == SubLegState.TRUE_SWING
    unload = sub == SubLegState.UNLOAD_FORCE
    left_unload = (unload[:, :-1] & ~unload[:, 1:]).any(1)   # [B, 4]
    assert swinging.sum(-1).max() <= 1
    assert swinging.any(1).sum() > 0
    assert not (left_unload & ~swinging.any(1)).any()
    # Replan ticks: a leg enters its swing window (or, on the first tick,
    # no plan is latched yet).
    prev = np.concatenate([np.ones_like(sub[:, :1]), sub[:, :-1]], 1)
    entering = ((sub == SubLegState.FULL_STANCE) & (prev == 1)).any((0, 2))
    entering[0] = True
    assert asked["sqp_calls"] == int(entering.sum())
    assert bench_walk.alive(loop).mean().item() >= 0.99


@pytest.mark.parametrize("shortcut", [True, False])
def test_runner_boot(cuda_device, monkeypatch, shortcut):
    """B=1024 robots boot sitting and ramp up on estimates from noisy
    sensors (noise level 1): with the ramp's shortcut, 200 ticks, every
    scenario in STAND_UP and K1 only at the boot; without it, 20 ticks and
    K1 once a tick (the locomotion step it skips)."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner

    batch = 1024
    ticks = 200 if shortcut else 20
    config = (None if shortcut
              else bench_runner.default_config(cuda_device, False))
    asked, before = count_qps(monkeypatch), launches()
    loop = bench_runner.build(batch, cuda_device, config=config)
    loop, _ = bench_runner.run(loop, ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=1 if shortcut else 1 + ticks)
    if shortcut:
        assert _finite(loop.sim, loop.runner)
        assert (loop.runner.fsm.state == 1).all().item()


def test_runner_switch(cuda_device, monkeypatch):
    """The fixture's checkpoint 100 ticks before STAND_UP -> LOCOMOTION,
    tiled to B=1024, vx ~ U(0.15, 0.3), noise from a torch.Generator, 250
    ticks: every scenario switches on the fixture's tick, at least 99%
    alive with final heights in [0.2, 0.35] m, the mean |v_est - v_true|
    over LOCOMOTION ticks below the JAX test's 0.15 m/s, K1 once a
    solve."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner

    batch, ticks = 1024, 250
    base, _, _ = bench_runner.window_loop(np.load(bench_runner.FIXTURE),
                                          ("switch",), cuda_device)
    vx = (0.15 + 0.15 * np.random.default_rng(0).random(batch)).astype(
        np.float32)
    loop = bench_runner.tile(base, batch, vx, 1.0, seed=1)
    switch_at = 1500 - 1 - bench_runner.CHECKPOINTS["switch"][0]
    asked, before = count_qps(monkeypatch), launches()
    loop, tr = bench_runner.run(loop, ticks, record=True)
    torch.cuda.synchronize()
    assert_launches(before, asked,
                    k1=math.ceil((ticks - switch_at) / CYCLE))
    fsm = tr["fsm"]
    assert ((fsm == 2).int().argmax(1) == switch_at).all().item()
    assert (fsm[:, switch_at:] == 2).all().item()
    assert (fsm[:, :switch_at] == 1).all().item()
    assert _finite(loop.sim, loop.runner)
    alive = bench_runner.alive(loop) > 0.5
    assert alive.float().mean().item() >= 0.99
    h = loop.sim.fb.position[alive, 2]
    assert 0.2 <= h.min().item() and h.max().item() <= 0.35
    loco = (fsm == 2)[..., None]
    verr = ((tr["v_est"] - tr["v_true"]).abs() * loco).sum() \
        / (loco.sum() * 3)
    assert verr.item() < 0.15
