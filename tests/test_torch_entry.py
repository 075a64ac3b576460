"""The port's entry twin (quadruped_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.entry()`.

* The JAX entry's booted state (32 A1 scenarios, vx from 0 to 0.6, the
  16-iteration cold start) carried across with `to_torch`, then one tick
  through each package's `fn`: tau within 0.3 N m and the forces within 1%
  m*g (measured on this CPU: 0.031 N m and 0.21 N).
* The port's own booted state against the JAX one: the same commands
  (within 6e-8 m/s: two float32 linspaces), the cold-started MPC forces
  within the force limit (measured 0.047 N), and its first tick as above
  (0.034 N m, 0.19 N).
* On CPU tensors the entry builds and returns CPU tensors.
"""

import functools

import jax
import numpy as np
import torch

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionState
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.entry import BATCH, entry
from quadruped_tpu_torch.utils.convert import to_torch

MG = 13.0 * 9.81
TAU_TOL = 0.3
FORCE_TOL = 0.01 * MG


@functools.lru_cache(maxsize=None)
def _jax_entry():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    tau, forces = jax.jit(fn)(*args)
    return args, np.asarray(tau), np.asarray(forces)


def _carried(args):
    ctrl, obs, cmd, t = args
    return (to_torch(ctrl, LocomotionState), to_torch(obs, RobotObservation),
            to_torch(cmd, TwistCommand), torch.as_tensor(np.array(t)))


def _max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def test_entry_tick_matches_jax_on_the_same_state():
    args, tau_ref, forces_ref = _jax_entry()
    fn, _ = entry(device="cpu")
    tau, forces = fn(*_carried(args))
    assert tau.shape == (BATCH, 12) and forces.shape == (BATCH, 4, 3)
    assert torch.isfinite(tau).all() and torch.isfinite(forces).all()
    assert _max_err(tau, tau_ref) <= TAU_TOL
    assert _max_err(forces, forces_ref) <= FORCE_TOL


def test_entry_state_matches_jax():
    """The port's own args: the commands equal the JAX entry's, and its
    booted MPC forces and first tick agree with JAX's within the limits."""
    args, tau_ref, forces_ref = _jax_entry()
    ctrl_ref, obs_ref, cmd_ref, _ = _carried(args)
    fn, (ctrl, obs, cmd, t) = entry(device="cpu")
    assert _max_err(cmd.linear, cmd_ref.linear) <= 1e-7
    assert torch.equal(cmd.body_height, cmd_ref.body_height)
    assert torch.equal(obs.base_position, obs_ref.base_position)
    assert torch.equal(t, torch.full((BATCH,), 0.002))
    assert _max_err(ctrl.mpc.forces_world, ctrl_ref.mpc.forces_world) \
        <= FORCE_TOL
    tau, forces = fn(ctrl, obs, cmd, t)
    assert _max_err(tau, tau_ref) <= TAU_TOL
    assert _max_err(forces, forces_ref) <= FORCE_TOL


def test_entry_on_cpu_returns_cpu_tensors():
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in (args[1].base_position,
                                                args[2].linear, args[3]))
    tau, forces = fn(*args)
    assert tau.device.type == "cpu" and forces.device.type == "cpu"
