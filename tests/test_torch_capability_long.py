"""Full-length closed loops of the port with the JAX capability tests' own
assertions (minutes each; left out of tier-1 by the `slow` marker):

* the twins of tests/test_long_horizon_closed_loop.py: the H=16
  move-blocked trot against H=10 (2,000 ticks each), the scheduled stop
  through the velocity preview at H=10 and H=16 (3,000 ticks each), and
  the scheduled crouch through the height preview (3,000 ticks), all on
  the SRB sim;
* the twins of the four tests of tests/test_high_speed_trot.py that
  test_torch_runner_long.py does not hold: FAST_TROT at vx = 1.5 (>= 1.0
  m/s achieved), TROT backward at -0.5 m/s, the sprint configuration at
  2.0 (>= 1.5 m/s) and FAST_TROT backward at the -1.0 m/s command bound,
  5 s each on the whole-body sim.

Each runs on the CPU and, with the `cuda` marker, on the card (skipped
without one; K1 solves every MPC problem there):

    python -m pytest --noconftest -p no:cacheprovider -m "slow and cuda" \\
        tests/test_torch_capability_long.py --durations=0

The port imports no JAX, so these hold it to the physics the JAX tests
assert; tests/test_torch_preview.py holds the preview channel to JAX's
numbers.
"""

import numpy as np
import pytest
import torch

from card_device import DEVICES, cuda
from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.gait import ADVANCED_TROT, FAST_TROT, TROT
from quadruped_tpu_torch.gait.scheduler import _config, stance_contact_mask
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim.rollout import rollout

pytestmark = pytest.mark.slow

DT = 0.002
# The sprint's MPC state weights (tests/test_high_speed_trot.py).
SPRINT_WEIGHTS = (10, 10, 5, 40, 60, 100, 0, 0, 0.5, 20.0, 5, 1, 0.0)


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    return cuda()


def h10(**kw):
    return mpc_mod.MpcConfig(horizon=10, qp_cold_iters=400, **kw)


def h16():
    return mpc_mod.long_horizon_config(qp_cold_iters=400)


# --- tests/test_long_horizon_closed_loop.py ---------------------------------

def trot(mpc_cfg, device, steps=2000):
    config = LocomotionConfig(mpc=mpc_cfg, swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(device))
    res = rollout(config, a1_params(device),
                  TwistCommand.constant(vx=0.3, device=device), steps)
    return (float(res.alive[0]), res.base_height_trace[0].cpu().numpy(),
            res.vel_trace[0, :, 0].cpu().numpy())


def test_h16_trot_matches_h10(device):
    alive16, h16_, v16 = trot(h16(), device)
    assert alive16 == 1.0
    alive10, h10_, v10 = trot(h10(), device)
    assert alive10 == 1.0
    tail = slice(1200, 2000)
    assert np.isfinite(h16_).all()
    assert abs(h16_[tail].mean() - h10_[tail].mean()) < 0.02
    assert abs(v16[tail].mean() - v10[tail].mean()) < 0.08
    assert h16_[tail].min() > 0.2


def preview_loop(mpc_cfg, device, seconds, cmd_at, preview_at, channel):
    """The JAX tests' scan as a loop: tick i at t = (i + 1) DT (float32),
    the command cmd_at(t) (vx, body height) and the preview
    preview_at(t + k dt_mpc) [H] through `channel`; base x and z after
    each tick."""
    params = a1_params(device)
    config = LocomotionConfig(mpc=mpc_cfg, swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(device))
    sim = srb_sim.srb_sim_init(params, 1)
    ctrl = locomotion_init(config, params, srb_sim.observe(
        params, sim, torch.ones(1, 4, device=device)))
    steps = int(seconds / DT)
    ahead = np.arange(mpc_cfg.horizon, dtype=np.float32) \
        * np.float32(mpc_cfg.dt_mpc)
    xs = torch.empty(steps, device=device)
    hs = torch.empty(steps, device=device)
    for i in range(steps):
        t = np.float32(i + 1) * np.float32(DT)
        vx, height = cmd_at(t)
        cmd = TwistCommand.constant(vx=vx, body_height=height,
                                    device=device)
        preview = torch.as_tensor(preview_at(t + ahead)[None], device=device)
        obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
        command, forces, ctrl = locomotion_step(
            config, params, ctrl, obs, cmd,
            torch.full((1,), float(t), device=device), **{channel: preview})
        stance = stance_contact_mask(ctrl.gait)
        sim = srb_sim.srb_sim_step(
            params, sim, forces, stance, command.q, command.dq,
            1.0 - torch.repeat_interleave(stance, 3, dim=-1), DT)
        xs[i], hs[i] = sim.position[0, 0], sim.position[0, 2]
    return xs.cpu().numpy(), hs.cpu().numpy()


def test_h16_preview_transition_beats_h10(device):
    v, t_stop, t_end = 0.5, 4.0, 6.0

    def profile(t):
        return np.where(np.asarray(t) < t_stop, v, 0.0).astype(np.float32)

    def run(cfg):
        xs, hs = preview_loop(cfg, device, t_end,
                              lambda t: (profile(t), 0.27), profile,
                              "v_preview")
        i_stop = int(t_stop / DT)
        return xs[-1] - xs[i_stop], hs[i_stop:].min(), hs

    over10, hmin10, hs10 = run(h10())
    over16, hmin16, hs16 = run(h16())
    assert np.isfinite(hs10).all() and np.isfinite(hs16).all()
    assert hmin10 > 0.15 and hmin16 > 0.15
    assert over16 < 0.75 * over10, (over16, over10)
    assert hmin16 > hmin10 - 0.01, (hmin16, hmin10)


def test_height_preview_crouch(device):
    def zsched(t):
        t = np.asarray(t)
        ramp = np.clip((t - 2.5) / 0.3, 0.0, 1.0) \
            * np.clip((4.0 - t) / 0.3, 0.0, 1.0)
        return (0.27 - 0.05 * np.clip(ramp, 0.0, 1.0)).astype(np.float32)

    _, hs = preview_loop(h10(), device, 6.0, lambda t: (0.2, zsched(t)),
                         zsched, "z_preview")
    steps = len(hs)
    t = np.arange(steps) * DT
    zs = 0.27 - 0.05 * np.clip((t - 2.5) / 0.3, 0, 1) \
        * np.clip((4.0 - t) / 0.3, 0, 1)
    assert np.isfinite(hs).all()
    plat = slice(int(3.2 / DT), int(3.6 / DT))
    assert abs(hs[plat].mean() - 0.22) < 0.01, hs[plat].mean()
    assert np.abs(hs[plat] - 0.22).max() < 0.025
    late = slice(int(1.5 / DT), steps)
    assert np.abs(hs[late] - zs[late]).max() < 0.03


# --- tests/test_high_speed_trot.py ------------------------------------------

def whole_body_trot(vx_cmd, gait, device, seconds=5.0, swing_cfg=None,
                    mpc_kw=None):
    """(heights, world vx, pitch before each tick) of the JAX
    run_whole_body_trot: the whole-body closed loop of
    benchmarks/whole_body.py at MpcConfig(horizon=5, qp_iters=24,
    qp_cold_iters=120)."""
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120,
                              **(mpc_kw or {})),
        swing=swing_cfg or swing_mod.SwingConfig(), gait=gait)
    loop = bench_wb.build(1, device, config, vx=[vx_cmd])
    steps = int(seconds / DT)
    pitch = torch.zeros(steps + 1, device=device)

    def on_tick(k, sim, flags):
        pitch[k + 1] = se3.quat_to_rpy(sim.fb.quat)[0, 1]

    pitch[0] = se3.quat_to_rpy(loop.sim.fb.quat)[0, 1]
    _, (h, vx) = bench_wb.run(loop, steps, on_tick=on_tick)
    return (h[0].cpu().numpy(), vx[0].cpu().numpy(),
            pitch[:-1].cpu().numpy())


def assert_alive(h, pitch):
    tail = slice(int(len(h) * 0.6), len(h))
    assert np.isfinite(h).all()
    assert (h[tail] > 0.15).all(), h[tail].min()
    assert (np.abs(pitch) < 0.5).all(), np.abs(pitch).max()


def tail_mean(vxs):
    return vxs[int(len(vxs) * 0.6):].mean()


def test_trot_one_meter_per_second(device):
    h, vxs, pitch = whole_body_trot(1.5, FAST_TROT(device), device)
    assert_alive(h, pitch)
    assert tail_mean(vxs) >= 1.0, tail_mean(vxs)


def test_trot_backward(device):
    h, vxs, pitch = whole_body_trot(-0.5, TROT(device), device)
    assert_alive(h, pitch)
    assert tail_mean(vxs) <= -0.3, tail_mean(vxs)


def test_trot_one_point_five_meters_per_second(device):
    gait = _config(0.15, 0.5, [0.5, 0.0, 0.0, 0.5], device=device)
    swing_cfg = swing_mod.SwingConfig(foothold_clip=0.3,
                                      foothold_forward_gain=0.3)
    h, vxs, pitch = whole_body_trot(
        2.0, gait, device, swing_cfg=swing_cfg,
        mpc_kw=dict(state_weights=SPRINT_WEIGHTS))
    assert_alive(h, pitch)
    assert tail_mean(vxs) >= 1.5, tail_mean(vxs)
    assert (np.abs(pitch) < 0.25).all(), np.abs(pitch).max()


def test_trot_backward_at_command_bound(device):
    swing_cfg = swing_mod.SwingConfig(foothold_clip=0.3,
                                      foothold_forward_gain=0.5)
    h, vxs, pitch = whole_body_trot(
        -1.0, FAST_TROT(device), device, swing_cfg=swing_cfg,
        mpc_kw=dict(state_weights=SPRINT_WEIGHTS))
    assert_alive(h, pitch)
    assert tail_mean(vxs) <= -0.75, tail_mean(vxs)
