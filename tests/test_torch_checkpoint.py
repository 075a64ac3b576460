"""The port's checkpoint / resume (quadruped_tpu_torch/utils/checkpoint.py).

The six JAX tests of tests/test_checkpoint.py on the port (CPU): the carry
round-trips through a checkpoint (its step counter an int again), a
template of another structure, shape or dtype is refused with the
offending field paths named, a rollout in segments is bitwise the one-shot
rollout, a sweep re-invoked after an interrupt resumes from its newest
checkpoint and ends bitwise where the uninterrupted run ends (a fleet of
two robots), and `total_steps` must divide into segments. The port's
rollout is one eager tick loop, so the one-shot and the segmented runs are
bitwise equal here as well (the JAX tests allow roundoff between two
compiled graphs).
"""

import os

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params, stack_params
from quadruped_tpu_torch.sim.rollout import (rollout, rollout_init,
                                             rollout_segment)
from quadruped_tpu_torch.utils import checkpoint as ckpt
from quadruped_tpu_torch.utils import tree

torch.set_num_threads(1)


def _config():
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=12),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT("cpu"))


def _cmd(batch=2):
    return TwistCommand.constant(vx=0.3, body_height=0.27, batch=batch,
                                 device="cpu")


def _tree_equal(a, b) -> bool:
    la, lb = dict(tree.leaves(a)), dict(tree.leaves(b))
    return la.keys() == lb.keys() and all(
        np.array_equal(la[k], lb[k]) for k in la)


def test_save_restore_roundtrip(tmp_path):
    carry = rollout_init(_config(), a1_params("cpu"), 2)
    carry, _ = rollout_segment(_config(), a1_params("cpu"), _cmd(), carry, 3)
    path = str(tmp_path / "c.npz")
    ckpt.save(path, carry)
    back = ckpt.restore(path, tree.map_tensors(torch.zeros_like, carry))
    assert _tree_equal(carry, back)
    assert back.step == 3 and isinstance(back.step, int)
    assert back.ctrl.mpc.iteration.dtype == torch.int32
    with np.load(path) as data:
        assert data["step"].shape == () and "sim.position" in data.files
        assert "ctrl.gait.leg_state" in data.files


def test_restore_rejects_structure_mismatch(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing=\\['b'\\]"):
        ckpt.restore(path, {"a": torch.zeros(3), "b": torch.zeros(1)})


def test_segments_match_single_rollout():
    """One-shot vs two segments of 40 ticks: bitwise, and re-running the
    segments from the same carry reproduces them."""
    config, params, cmd = _config(), a1_params("cpu"), _cmd()
    whole = rollout(config, params, cmd, steps=80)
    carry0 = rollout_init(config, params, 2)
    carry, _ = rollout_segment(config, params, cmd, carry0, 40)
    carry, last = rollout_segment(config, params, cmd, carry, 40)
    assert carry.step == 80
    assert torch.equal(whole.sim.position, carry.sim.position)
    assert torch.equal(whole.base_height_trace[:, -40:],
                       last.base_height_trace)
    assert torch.equal(whole.alive, 1.0 - carry.dead)
    assert _tree_equal(whole.control, carry.ctrl)
    carry_b, _ = rollout_segment(config, params, cmd, carry0, 40)
    carry_b, last_b = rollout_segment(config, params, cmd, carry_b, 40)
    assert torch.equal(last.base_height_trace, last_b.base_height_trace)
    assert _tree_equal(carry, carry_b)


def test_checkpointed_rollout_resumes_after_interrupt(tmp_path):
    """A fleet (A1 and Lite3): "crash" after 2 of 4 segments, re-invoke
    for the whole sweep; bitwise the uninterrupted run; two checkpoints
    kept."""
    config, params, cmd = _config(), stack_params(("a1", "lite3"), "cpu"), \
        _cmd()
    d = str(tmp_path / "ckpts")
    ckpt.checkpointed_rollout(config, params, cmd, total_steps=40,
                              segment_steps=20, directory=d)
    assert ckpt.latest(d)[1] == 40
    carry, last = ckpt.checkpointed_rollout(config, params, cmd,
                                            total_steps=80,
                                            segment_steps=20, directory=d)
    assert carry.step == 80 and last.base_height_trace.shape == (2, 20)
    carry_u = rollout_init(config, params, 2)
    for _ in range(4):
        carry_u, last_u = rollout_segment(config, params, cmd, carry_u, 20)
    assert _tree_equal(carry_u, carry)
    assert torch.equal(last_u.base_height_trace, last.base_height_trace)
    whole = rollout(config, params, cmd, steps=80)
    assert torch.equal(whole.sim.position, carry.sim.position)
    names = sorted(os.listdir(d))
    assert names == [os.path.basename(ckpt.checkpoint_path(d, s))
                     for s in (60, 80)]
    # Asking again for the same sweep runs nothing more.
    again, none = ckpt.checkpointed_rollout(config, params, cmd, 80, 20, d)
    assert none is None and _tree_equal(again, carry)


def test_total_steps_must_divide(tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        ckpt.checkpointed_rollout(_config(), a1_params("cpu"), _cmd(1),
                                  total_steps=50, segment_steps=20,
                                  directory=str(tmp_path / "unused"))


def test_restore_rejects_shape_mismatch(tmp_path):
    """Another batch size or dtype fails at restore, naming the fields."""
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": torch.ones(3, 4)})
    with pytest.raises(ValueError, match="shape/dtype"):
        ckpt.restore(path, {"a": torch.zeros(5, 4)})
    with pytest.raises(ValueError, match="shape/dtype"):
        ckpt.restore(path, {"a": torch.zeros(3, 4, dtype=torch.int32)})
    carry = rollout_init(_config(), a1_params("cpu"), 2)
    ckpt.save(path, carry)
    with pytest.raises(ValueError, match="sim.position: saved float32"):
        ckpt.restore(path, rollout_init(_config(), a1_params("cpu"), 3))
