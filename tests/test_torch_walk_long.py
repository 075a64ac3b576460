"""Full-length twins of the JAX walk and gait-transition closed loops, on
the port alone (CPU, marked slow: the tier-1 run leaves them out).

* The 13 s statically-stable walk of tests/test_walk_locomotion.py
  (`test_walk_closed_loop_stable`: SRB sim, WALK(), 300 ADMM iterations,
  vx = 0.015): 6,500 ticks, with the JAX test's checks.
* The whole trot -> walk -> trot sequence of tests/test_gait_transition.py
  (`test_closed_loop_trot_walk_trot`: 400 + 400 + 1000 + 400 + 900 ticks),
  with the JAX test's checks.

The port's eager CPU tick makes these minutes long (the walk ~0.15 s a
tick); tests/test_torch_walk_windows.py and test_torch_gait_transition.py
hold windows of them against JAX in the tier-1 run.

    python -m pytest -q -m slow tests/test_torch_walk_long.py
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import transition
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.gait_transition import TransitionPhase
from quadruped_tpu_torch.control.walk_locomotion import walk_init
from quadruped_tpu_torch.gait import WALK
from quadruped_tpu_torch.gait.walk import SubLegState
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import rollout as rollout_mod
from quadruped_tpu_torch.sim import srb_sim


@pytest.mark.slow
def test_walk_closed_loop_stable():
    params = a1_params("cpu")
    config = bench_walk.walk_config(WALK("cpu"), qp_iters=300)
    sim = srb_sim.srb_sim_init(params, 1)
    walk = walk_init(config, params,
                     srb_sim.observe(params, sim, torch.ones(1, 4)))
    cmd = TwistCommand.constant(vx=0.015, body_height=0.27, device="cpu")
    loop = bench_walk.Loop(config, params, cmd, sim, walk,
                           np.zeros(1, np.int64))
    _, tr = bench_walk.run(loop, 6500, record=True)
    h = tr["position"][0, :, 2].numpy()
    x = tr["position"][0, :, 0].numpy()
    subs = tr["sub_state"][0].numpy()
    assert np.all(np.isfinite(h))
    assert h.min() > 0.22 and h.max() < 0.32, (h.min(), h.max())
    assert x[-1] > x[0] + 0.05, (x[0], x[-1])
    swinging = subs == SubLegState.TRUE_SWING
    assert swinging.any(0).all()
    assert swinging.sum(1).max() <= 1


@pytest.mark.slow
def test_closed_loop_trot_walk_trot():
    config, params = transition.config("cpu"), a1_params("cpu")
    carry = rollout_mod.rollout_init(config, params, 1)

    def seg(carry, switch, steps):
        cmd = TwistCommand.constant(vx=0.25, gait_switch=switch,
                                    device="cpu")
        return rollout_mod.rollout_segment(config, params, cmd, carry, steps)

    phase = lambda c: int(c.ctrl.transition.phase[0])  # noqa: E731
    carry, res = seg(carry, 0.0, 400)
    assert float(res.alive[0]) == 1.0
    assert phase(carry) == TransitionPhase.NONE
    carry, res = seg(carry, 1.0, 400)
    assert float(res.alive[0]) == 1.0
    assert phase(carry) in (TransitionPhase.DECEL, TransitionPhase.STAND)
    assert (res.forces_trace[0, -1, :, 2] > 1.0).all()
    carry, res = seg(carry, 0.0, 1000)
    assert float(res.alive[0]) == 1.0
    assert phase(carry) == TransitionPhase.NONE
    assert float(carry.ctrl.transition.active_idx[0]) == 1.0
    fz = res.forces_trace[0, -300:, :, 2].numpy()
    assert (4 - (fz > 0.5).sum(-1)).max() <= 2
    carry, res = seg(carry, 1.0, 400)
    carry, res = seg(carry, 0.0, 900)
    assert float(res.alive[0]) == 1.0
    assert phase(carry) == TransitionPhase.NONE
    assert float(carry.ctrl.transition.active_idx[0]) == 0.0
