"""The port's closed loops on the SRB simulator at full batch, on the card
(marker `cuda`; skipped without one). Imports no JAX.

* `rollout_cadenced` for B=2048 A1 scenarios at the production MPC
  configuration (H=10), 18 MPC periods, vx ~ U(0.2, 0.8), wz ~ N(0, 0.2);
* `rollout` in VELOCITY and POSITION mode (TROT, `ForceBalanceConfig()`),
  B=2048, 100 ticks, vx ~ U(0.1, 0.4) and U(0, 0.1);
* the WBC: `wbc_step` on the B=1024 states of benchmarks/wbc.py, then
  `rollout` with `use_wbc` at B=1024 (`MpcConfig(horizon=10)`, 400 ticks,
  vx ~ U(0.2, 0.6));
* online gait transitions: the trot -> walk -> trot sequence of the JAX
  test_closed_loop_trot_walk_trot (benchmarks/transition.py) at B=64,
  `gait_switch` raised in other segments per scenario;
* the RC channel on the ground-truth runner, B=2048, 200 ticks: X starts
  the trot, and half the scenarios press B, Rb, Rb (BODY_DOWN).

Each holds at least 99% of scenarios alive (all, where a path has no
other check), every state finite, K1 once a batched MPC solve (the
boot's included) and no other MPC kernel, and the dense-QP kernel once a
QP its callers asked for (tests/card_device.py). The fixtures of these
loops are held on the card by the `cuda` cases of the CPU tests
(test_torch_rollout.py, _locomotion_modes.py, _wbc.py,
_gait_transition.py, _runner.py).
"""

import math

import numpy as np
import pytest
import torch

from card_device import (assert_launches, count_qps,  # noqa: F401
                         cuda_device, launch_record, launches)
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                       TwistCommand)
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import rollout as rollout_mod

pytestmark = pytest.mark.cuda

BATCH = 2048
CYCLE = 8          # ticks an MPC period


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _sim_tensors(res) -> list:
    return [getattr(res.sim, f) for f in res.sim.__dataclass_fields__]


def test_cadenced_rollout(cuda_device, monkeypatch):
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

    periods = 18
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(cuda_device))
    rng = np.random.default_rng(0)
    vx = (0.2 + 0.6 * rng.random(BATCH)).astype(np.float32)
    wz = (rng.normal(size=BATCH) * 0.2).astype(np.float32)
    asked, before = count_qps(monkeypatch), launches()
    res = rollout_cadenced(config, a1_params(cuda_device),
                           TwistCommand.constant(vx=vx, wz=wz,
                                                 device=cuda_device),
                           periods)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=1 + periods)
    assert _finite(*_sim_tensors(res), res.base_height_trace, res.vel_trace)
    assert res.alive.mean().item() >= 0.99


@pytest.mark.parametrize("mode", ["velocity", "position"])
def test_force_balance_modes(cuda_device, monkeypatch, mode):
    """No MPC kernel; the dense-QP kernel once a tick (the force balance's
    whitened QP)."""
    from quadruped_tpu_torch.control.stance_force_balance import \
        ForceBalanceConfig
    from quadruped_tpu_torch.gait import TROT

    ticks = 100
    rng = np.random.default_rng(0)
    vx = {"velocity": (0.1 + 0.3 * rng.random(BATCH)).astype(np.float32)}
    vx["position"] = (0.1 * rng.random(BATCH)).astype(np.float32)
    control = {"velocity": ControlMode.VELOCITY,
               "position": ControlMode.POSITION}[mode]
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                              swing=swing_mod.SwingConfig(mode=control),
                              gait=TROT(cuda_device), mode=control,
                              force_balance=ForceBalanceConfig())
    asked, before = count_qps(monkeypatch), launches()
    res = rollout_mod.rollout(config, a1_params(cuda_device),
                              TwistCommand.constant(vx=vx[mode],
                                                    body_height=0.27,
                                                    device=cuda_device),
                              ticks)
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=0)
    assert asked["solve_factored"] == ticks
    assert _finite(*_sim_tensors(res), res.base_height_trace, res.vel_trace,
                   res.forces_trace)
    assert res.alive.mean().item() >= 0.99


def test_wbc_step(cuda_device, monkeypatch):
    """Ten `wbc_step` calls on the B=1024 states of benchmarks/wbc.py: no
    MPC kernel, the dense-QP kernel once a call, every output finite."""
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc

    step, args = bench_wbc.build(1024, cuda_device)
    asked, before = count_qps(monkeypatch), launches()
    for _ in range(10):
        out = step(*args)
    torch.cuda.synchronize()
    assert asked["wbc_step"] == 10
    assert_launches(before, asked, k1=0)
    assert _finite(*out)


def test_wbc_rollout(cuda_device, monkeypatch):
    """The WBC runs on every 2nd tick that solves no MPC (150 of 400),
    the dense-QP kernel once on each of them."""
    from quadruped_tpu_torch.control import wbc as wbc_mod

    batch, ticks = 1024, 400
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(cuda_device),
                              wbc=wbc_mod.WbcConfig(), use_wbc=True)
    rng = np.random.default_rng(0)
    cmd = TwistCommand.constant(
        vx=(0.2 + 0.4 * rng.random(batch)).astype(np.float32),
        body_height=0.27, device=cuda_device)
    asked, before = count_qps(monkeypatch), launches()
    res = rollout_mod.rollout(config, a1_params(cuda_device), cmd, ticks)
    torch.cuda.synchronize()
    assert asked["wbc_step"] == sum(1 for i in range(ticks)
                                    if i % 2 == 0 and i % CYCLE)
    assert_launches(before, asked, k1=1 + math.ceil(ticks / CYCLE))
    assert _finite(*_sim_tensors(res), res.base_height_trace, res.vel_trace,
                   res.forces_trace, res.tau_trace)
    assert res.alive.mean().item() >= 0.99


# The gait_switch level of each segment, by pattern; rows 0-3 switch as
# the CPU test's scenarios (tests/test_torch_gait_transition.py).
SWITCH_PATTERNS = ((0, 1, 0, 1, 0), (0, 1, 0, 0, 0), (0, 0, 0, 1, 0),
                   (0, 0, 0, 0, 0), (1, 0, 0, 1, 0))


def test_gait_transitions(cuda_device, monkeypatch):
    """trot -> walk -> trot (400 + 400 + 1000 + 400 + 900 ticks) at B=64,
    vx ~ U(0.15, 0.35): every scenario ends in phase NONE on the table its
    rising switch edges lead to, at most two legs unloaded on the walk
    table over the last 300 ticks of segment 3, and some scenarios walk
    there."""
    from quadruped_tpu_torch.benchmarks import transition

    batch = 64
    params = a1_params(cuda_device)
    config = transition.config(cuda_device)
    pattern = np.asarray([SWITCH_PATTERNS[i % len(SWITCH_PATTERNS)]
                          for i in range(batch)], np.float32)
    pattern[:4] = [SWITCH_PATTERNS[0], SWITCH_PATTERNS[0],
                   SWITCH_PATTERNS[3], SWITCH_PATTERNS[3]]
    rng = np.random.default_rng(0)
    vx = (0.15 + 0.2 * rng.random(batch)).astype(np.float32)
    vx[:4] = 0.25
    asked, before = count_qps(monkeypatch), launches()
    carry = rollout_mod.rollout_init(config, params, batch)
    for s, steps in enumerate(transition.SEGMENTS):
        cmd = TwistCommand.constant(vx=vx, body_height=0.27,
                                    gait_switch=pattern[:, s],
                                    device=cuda_device)
        carry, res = rollout_mod.rollout_segment(config, params, cmd, carry,
                                                 steps)
        if s == 2:
            on_walk = carry.ctrl.transition.active_idx.cpu().numpy() > 0.5
            fz = res.forces_trace[:, -300:, :, 2].cpu().numpy()
    torch.cuda.synchronize()
    ticks = sum(transition.SEGMENTS)
    assert_launches(before, asked, k1=1 + math.ceil(ticks / CYCLE))
    edges = ((pattern[:, 1:] > 0.5) & (pattern[:, :-1] <= 0.5)).sum(1) \
        + (pattern[:, 0] > 0.5)
    final = carry.ctrl.transition
    assert (final.phase == 0).all().item()
    np.testing.assert_array_equal(final.active_idx.cpu().numpy(),
                                  (edges % 2).astype(np.float32))
    assert (1.0 - carry.dead).mean().item() >= 0.99
    assert on_walk.any()
    assert (4 - (fz[on_walk] > 0.5).sum(-1)).max() <= 2


def test_rc_sit_down(cuda_device, monkeypatch):
    """The ground-truth runner on the SRB sim with `rc_update`, B=2048,
    200 ticks: X starts the trot; the odd scenarios press B, Rb, Rb from
    tick 20 + 10 k and enter SIT_DOWN four ticks later, the others never;
    K1 once a tick that solves (and the boot's)."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner
    from quadruped_tpu_torch.control.fsm import FsmState
    from quadruped_tpu_torch.control.rc_mode import (BUTTONS, JoyInput,
                                                     rc_init, rc_update)
    from quadruped_tpu_torch.exec import RunnerConfig
    from quadruped_tpu_torch.utils import tree

    ticks = 200
    dev = cuda_device
    config = RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev)))
    down = np.where(np.arange(BATCH) % 2 == 1,
                    20 + 10 * (np.arange(BATCH) // 2 % 16), -1)
    levels = np.zeros((ticks, len(BUTTONS), BATCH), np.float32)
    levels[0, BUTTONS.index("btn_gait")] = 1.0
    rows = np.nonzero(down >= 0)[0]
    for k, name in enumerate(("btn_stop", "btn_updown", "btn_updown")):
        levels[down[rows] + 2 * k, BUTTONS.index(name), rows] = 1.0
    levels = torch.as_tensor(levels, device=dev)
    vx_stick = torch.full((BATCH,), 0.3, device=dev)
    zero = torch.zeros(BATCH, device=dev)
    params = a1_params(dev)
    asked, before = count_qps(monkeypatch), launches()
    sim, st = bench_runner.srb_boot(config, params, BATCH)
    rc = rc_init(BATCH, device=dev)
    states, solving = [], 0
    for k in range(ticks):
        joy = JoyInput(vx=vx_stick, vy=zero, wz=zero, **{
            name: levels[k, i] for i, name in enumerate(BUTTONS)})
        rc, cmd, req, _ = rc_update(rc, joy, 0.27)
        solving += int(mpc_mod.solve_mask(config.locomotion.mpc,
                                          st.locomotion.mpc).any())
        sim, st, _, _ = bench_runner.srb_tick(config, params, sim, st, cmd,
                                              fsm_request=req)
        states.append(st.fsm.state.clone())
    torch.cuda.synchronize()
    assert_launches(before, asked, k1=1 + solving)
    states = torch.stack(states, 1).cpu().numpy()
    sat = (states == FsmState.SIT_DOWN).any(1)
    first_sit = np.where(sat, (states == FsmState.SIT_DOWN).argmax(1), -1)
    np.testing.assert_array_equal(first_sit, np.where(down >= 0, down + 4,
                                                       -1))
    assert all(bool(torch.isfinite(v).all()) for o in (sim, st)
               for _, v in tree.leaves(o)
               if isinstance(v, torch.Tensor) and v.is_floating_point())
