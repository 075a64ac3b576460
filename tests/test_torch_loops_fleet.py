"""The heterogeneous fleet (the A1, Go1, Aliengo and Lite3 in one batch)
on every path of the port at full batch, on the card (marker `cuda`;
skipped without one). Imports no JAX.

* benchmarks/fleet.py, the twin of the JAX examples/example_fleet_sweep.py:
  the four robots at vx 0, 0.2, 0.4, 0.6 (16 scenarios) tiled to B=2048,
  500 ticks of `rollout`; a B=64 fleet against each robot run alone with
  one-robot parameters over 100 ticks; its `checkpointed_rollout` resumed
  after a crash, and a trace round trip;
* benchmarks/fleet_paths.py: the four robots (a quarter of the batch
  each, commanded their body height less 1 cm) through VELOCITY and
  POSITION (B=2048, 40 ticks), the walk (B=256, 60 ticks), the WBC and
  the whole-body trot (B=1024, 100 ticks) and the runner's STAND_UP ramp
  (B=1024, 100 ticks); each path's B=64 fleet over 12 ticks against each
  robot run alone at B=16.

Every run holds every state finite, K1 once a batched MPC solve (the
boot's included) and no other MPC kernel, and the dense-QP kernel once a
QP its callers asked for (tests/card_device.py). The fleet fixture is
held on the card by the `cuda` case of tests/test_torch_scenarios.py.
"""

import numpy as np
import pytest
import torch

from card_device import (assert_launches, count_qps,  # noqa: F401
                         cuda_device, launch_record, launches)
from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
from quadruped_tpu_torch.benchmarks import fleet_paths as bench_paths
from test_torch_whole_body import CLOSED_TOL

pytestmark = pytest.mark.cuda

# The final heights' bound of the JAX fleet test, 0.06 m: off the commanded
# 0.27 m for every robot, and off each robot's own body height for the
# robots of the JAX test (the Aliengo, nominally 0.37 m, stands where the
# grid's command puts it, as in the JAX package); the copies of one
# scenario must agree.
HEIGHT_TOL, COPY_TOL = 0.06, 1e-3
JAX_TEST_ROBOTS = ("a1", "go1", "lite3")
# A fleet against each robot alone over 100 ticks, at 10x the spread of
# JAX's own one-float32-step nudges over the 150-tick fleet window
# (tests/test_torch_scenarios.py; a wrong broadcast moves heights by
# centimetres and forces by tens of newtons).
SINGLE_TOL = {"base_height_trace": 7.3e-5, "vel_trace": 1.9e-3,
              "forces_trace": 7.6, "q": 6.7e-4}
# Each path's B=64 fleet against each robot alone at B=16 over 12 ticks,
# on the base heights and the final joint angles: on the SRB sim at
# SINGLE_TOL; on the whole-body sim the card's batched kernels round a
# row's last bit by the batch size and the stiff contact grows it (1.1e-2
# rad of q after 20 walk ticks), so there at the limits
# tests/test_torch_whole_body.py holds the whole-body loop to between two
# implementations.
PATH_TOL = {"srb": {"height": SINGLE_TOL["base_height_trace"],
                    "q": SINGLE_TOL["q"]},
            "whole_body": {"height": CLOSED_TOL["height_trace"],
                           "q": CLOSED_TOL["q"]}}


def _finite(*objs) -> bool:
    from quadruped_tpu_torch.utils import tree

    return all(bool(torch.isfinite(v).all())
               for o in objs for _, v in tree.leaves(o)
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def test_fleet_sweep(cuda_device, monkeypatch):
    """B=2048, 500 ticks: at least 99% alive for each robot, final heights
    within HEIGHT_TOL of the command (and of their own body height for the
    JAX test's robots), the 128 copies of each scenario within
    COPY_TOL."""
    ticks = 500
    fleet = bench_fleet.build(128, cuda_device)
    asked, before = count_qps(monkeypatch), launches()
    res = bench_fleet.run(fleet, ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked,
                    k1=bench_fleet.mpc_solves(fleet.config, ticks))
    assert _finite(res)
    robots = bench_fleet.per_robot(fleet, res)
    assert min(r["alive"] for r in robots.values()) >= 0.99, robots
    alive = res.alive > 0.5
    final_h = res.base_height_trace[:, -1]
    assert (final_h - fleet.cmd.body_height)[alive].abs().max().item() \
        <= HEIGHT_TOL
    for r in JAX_TEST_ROBOTS:
        rows = alive & torch.tensor([x == r for x in fleet.robots],
                                    device=cuda_device)
        assert (final_h - fleet.params.body_height)[rows].abs().max() \
            .item() <= HEIGHT_TOL, r
    assert bench_fleet.copy_spread(fleet, res) <= COPY_TOL


def test_fleet_equals_each_robot_alone(cuda_device, tmp_path):
    """A B=64 fleet (the 16-scenario grid x4), 100 ticks, against each
    robot run alone with one-robot parameters, within SINGLE_TOL; then
    `checkpointed_rollout` of it in two 50-tick segments, called again
    after the first as after a crash: the resumed carry bit for bit the
    uninterrupted run's, and a trace save / load round trip exact."""
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.gait import named_gait
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod
    from quadruped_tpu_torch.utils import checkpoint, tree
    from quadruped_tpu_torch.utils.trace import (compare_traces, load_trace,
                                                 save_trace)

    batch, ticks = 64, 100
    fleet = bench_fleet.build(batch // 16, cuda_device)
    res = bench_fleet.run(fleet, ticks)
    for r in bench_fleet.ROBOTS:
        rows = torch.tensor([x == r for x in fleet.robots],
                            device=cuda_device)
        alone = rollout_mod.rollout(
            bench_fleet.config(named_gait(bench_fleet.GAITS[0],
                                          cuda_device)),
            named_params(r, cuda_device),
            TwistCommand.constant(vx=fleet.cmd.linear[rows, 0],
                                  device=cuda_device), ticks)
        for k, tol in SINGLE_TOL.items():
            a = alone.sim.q if k == "q" else getattr(alone, k)
            b = res.sim.q[rows] if k == "q" else getattr(res, k)[rows]
            assert (a - b).abs().max().item() <= tol, (r, k)

    seg = ticks // 2
    directory = str(tmp_path / "ckpt")
    checkpoint.checkpointed_rollout(fleet.config, fleet.params, fleet.cmd,
                                    seg, seg, directory)
    resumed, last = checkpoint.checkpointed_rollout(
        fleet.config, fleet.params, fleet.cmd, 2 * seg, seg, directory)
    carry = rollout_mod.rollout_init(fleet.config, fleet.params, batch)
    for _ in range(2):
        carry, last_u = rollout_mod.rollout_segment(
            fleet.config, fleet.params, fleet.cmd, carry, seg)
    a, b = (dict(tree.leaves(x)) for x in (resumed, carry))
    assert resumed.step == 2 * seg and a.keys() == b.keys()
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                else a[k] == b[k]), k
    assert torch.equal(last.base_height_trace, last_u.base_height_trace)
    save_trace(str(tmp_path / "trace.npz"), last, meta={"ticks": seg})
    back, _ = load_trace(str(tmp_path / "trace.npz"), like=last)
    assert compare_traces(last, back, atol=0.0)["within_tol"]


# (path, batch, ticks) of each path's fleet.
PATHS = (("velocity", 2048, 40), ("position", 2048, 40), ("walk", 256, 60),
         ("wbc", 1024, 100), ("wholebody", 1024, 100), ("runner", 1024, 100))


@pytest.mark.parametrize("path,batch,ticks", PATHS,
                         ids=[p for p, _, _ in PATHS])
def test_fleet_on_path(cuda_device, monkeypatch, path, batch, ticks):
    """Each robot's alive share (for the runner: not dropped to PASSIVE)
    at least 0.99, or no more than 0.01 below the same robot's run alone
    on its scenarios."""
    asked, before = count_qps(monkeypatch), launches()
    f = bench_paths.build(path, batch, cuda_device)
    f, tr = bench_paths.run(f, ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=int(bench_paths.boots_mpc(path))
                    + bench_paths.mpc_solves(f, ticks))
    assert all(bool(torch.isfinite(t).all())
               for t in bench_paths.state_tensors(f))
    assert torch.isfinite(tr["height"]).all()
    for robot, share in bench_paths.per_robot(f, bench_paths.alive(f)) \
            .items():
        if share < 0.99:
            a, _ = bench_paths.run(bench_paths.alone(f, robot, cuda_device),
                                   ticks)
            assert share >= bench_paths.alive(a).mean().item() - 0.01, robot


@pytest.mark.parametrize("path", bench_paths.PATHS)
def test_path_fleet_equals_each_robot_alone(cuda_device, monkeypatch, path):
    """The B=64 fleet of `path` (16 scenarios a robot; `runner_trot`: the
    runner booted standing in LOCOMOTION, K1 on the runner's MPC) over 12
    ticks against each robot alone at B=16 with one-robot parameters,
    within PATH_TOL of its simulator."""
    ticks = 12
    asked, before = count_qps(monkeypatch), launches()
    f = bench_paths.build(path, 64, cuda_device)
    f, tr = bench_paths.run(f, ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=int(bench_paths.boots_mpc(path))
                    + bench_paths.mpc_solves(f, ticks))
    sim = ("srb" if isinstance(f.loop, bench_paths.RolloutLoop)
           else "whole_body")
    for robot in bench_fleet.ROBOTS:
        a, tra = bench_paths.run(bench_paths.alone(f, robot, cuda_device),
                                 ticks)
        rows = torch.as_tensor(a.rows, device=cuda_device)
        for k, tol in PATH_TOL[sim].items():
            err = (tr[k][rows] - tra[k]).abs().max().item()
            assert err <= tol, (robot, k, err)
