"""Full-length closed loops of the port's robot runner, with the JAX tests'
own physical assertions (CPU, minutes each; left out of tier-1 by the
`slow` marker):

* the twin of tests/test_estimator_in_loop.py::test_standup_then_estimated_trot
  (3,000 ticks from the sitting boot: the 3 s STAND_UP ramp, then the
  advanced trot on estimates, noise levels 0 and 1);
* the twin of tests/test_high_speed_trot.py::test_trot_one_meter_per_second_estimated
  (FAST_TROT at vx = 1.5 m/s on estimates, 7 s);
* the twin of tests/test_rc_mode.py::test_rc_drives_fsm_sit_down (the RC
  machine trots the SRB runner, then B, Rb, Rb sit it down into PASSIVE).

The sensor noise comes from the port's `torch.Generator` (the JAX tests
draw theirs with `jax.random`), so these hold the port to the physics the
JAX tests assert, not to JAX's numbers; the windows of
tests/test_torch_runner.py do that.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import runner as bench_runner
from quadruped_tpu_torch.control.fsm import FsmState

torch.set_num_threads(1)

pytestmark = pytest.mark.slow

STEPS = 3000


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_standup_then_estimated_trot(noise):
    loop = bench_runner.build(1, "cpu", noise=noise, vx=0.2, seed=1)
    _, tr = bench_runner.run(loop, STEPS, record=True)
    fsm = tr["fsm"][0].numpy()
    pos = tr["position"][0].numpy()
    assert fsm[0] == FsmState.STAND_UP
    first_loco = int(np.argmax(fsm == FsmState.LOCOMOTION))
    assert 0 < first_loco < STEPS // 2
    assert (fsm[first_loco:] == FsmState.LOCOMOTION).all()
    assert np.isfinite(pos).all()
    assert 0.24 < pos[-1, 2] < 0.32, pos[-1]
    assert pos[-1, 0] > 0.15, pos[-1]
    loco = fsm == FsmState.LOCOMOTION
    verr = (tr["v_est"][0] - tr["v_true"][0]).abs().numpy()[loco]
    assert verr.mean() < 0.15, verr.mean()
    assert verr.max() < 1.0, verr.max()
    drift = np.abs(tr["p_est"][0, -1, :2].numpy() - pos[-1, :2])
    assert (drift < 0.45).all(), drift


def test_trot_one_meter_per_second_estimated():
    from quadruped_tpu_torch.gait import FAST_TROT
    from quadruped_tpu_torch.sim import whole_body as wb
    from quadruped_tpu_torch.exec import runner_init

    config = bench_runner.default_config("cpu")
    config.locomotion.gait = FAST_TROT("cpu")
    loop = bench_runner.build(1, "cpu", noise=1.0, vx=1.5, seed=3,
                              config=config)
    # Boot standing (the JAX test starts from whole_body_init's stand).
    sim = wb.whole_body_init(loop.params, 1)
    runner = runner_init(config, loop.params,
                         wb.observe(loop.params, loop.model, sim,
                                    loop.contact))
    loop = loop._replace(sim=sim, runner=runner)
    steps = int(7.0 / bench_runner.DT)
    _, tr = bench_runner.run(loop, steps, record=True)
    h = tr["position"][0, :, 2].numpy()
    vx = tr["v_true"][0, :, 0].numpy()
    tail = slice(int(len(h) * 0.8), len(h))
    assert np.isfinite(h).all()
    assert (h[tail] > 0.15).all(), h[tail].min()
    assert vx[tail].mean() >= 0.95, vx[tail].mean()


def test_rc_drives_fsm_sit_down():
    from quadruped_tpu_torch.control import mpc, swing
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.control.rc_mode import (JoyInput, rc_init,
                                                     rc_update)
    from quadruped_tpu_torch.exec import RunnerConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params

    h = 0.27
    params = a1_params("cpu")
    config = RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT("cpu")))
    sim, st = bench_runner.srb_boot(config, params, 1)
    rc = rc_init(1, device="cpu")
    rc, _, _, _ = rc_update(rc, JoyInput.neutral(btn_gait=1.0, vx=0.3,
                                                 device="cpu"), h)

    def run(sim, st, rc, joy, n):
        states = []
        for _ in range(n):
            rc, cmd, req, _ = rc_update(rc, joy, h)
            sim, st, _, _ = bench_runner.srb_tick(config, params, sim, st,
                                                  cmd, fsm_request=req)
            states.append(int(st.fsm.state))
        return sim, st, rc, np.asarray(states)

    sim, st, rc, _ = run(sim, st, rc, JoyInput.neutral(vx=0.3, device="cpu"),
                         500)
    assert int(st.fsm.state) == FsmState.LOCOMOTION
    for buttons in ({"btn_stop": 1.0}, {}, {"btn_updown": 1.0}, {}):
        rc, _, _, _ = rc_update(rc, JoyInput.neutral(device="cpu",
                                                     **buttons), h)
    rc, _, req, _ = rc_update(rc, JoyInput.neutral(btn_updown=1.0,
                                                   device="cpu"), h)
    assert int(req) == FsmState.SIT_DOWN
    _, _, _, states = run(sim, st, rc, JoyInput.neutral(device="cpu"), 1600)
    assert (states == FsmState.SIT_DOWN).any()
    assert states[-1] == FsmState.PASSIVE
