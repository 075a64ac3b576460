"""Fleets in the force-balance modes (VELOCITY and POSITION) on the port
against the JAX package and against each robot alone (CPU).

* `rollout` of a fleet of the five robots (stacked parameters; each
  commanded its nominal body height less 1 cm, vx from a seed as
  benchmarks/fleet_paths.py draws it for the mode; TROT,
  `ForceBalanceConfig()`), 40 ticks, against `jax.vmap` of the JAX
  `rollout` over the JAX `stack_params`, at the one-robot limits of
  tests/test_torch_locomotion_modes.py (TOL; forces 1% of the A1's m*g on
  the ticks where neither package's force-balance polish missed its
  minimizer). CPU readings (VELOCITY / POSITION, limit): height trace
  1.5e-7 / 4.8e-7 m (2e-4), position 8.2e-6 / 5.9e-6 m (2e-4), quat
  6.2e-5 / 3.9e-5 (5e-4), velocity 6.4e-4 / 1.3e-4 m/s (5e-3), its
  trace 1.0e-3 / 3.4e-4 (5e-3), angular velocity 1.1e-2 / 1.2e-3 rad/s
  (3e-2), joint angles 1.5e-4 / 9.6e-5 rad (2e-3), joint speeds 1.2e-2 /
  1.4e-3 rad/s (5e-2), touchdown anchors 4.2e-5 / 1.7e-5 m (1e-3),
  forces 0.14 / 0.046 N (1.28 N), on 99% of the ticks. (With
  `ForceBalanceConfig()`'s `track_xy` off, POSITION's CoM shift moves
  nothing but the command's x and y, in JAX as in the port.)
* One `locomotion_step` and `srb_sim_step` of a fleet (robots and gait
  tables cycling, vx and wz from a seed) from a mid-run carry, against
  each scenario run with its one-robot parameters and gait table, at
  B = 3, 4, 5 and 12: equal to float32 rounding
  (tests/test_torch_scenarios.py's method); a wrong broadcast is off by
  the difference between two robots. The one-robot run takes the whole
  carry and is read at the scenario's row, so that the row sits where it
  sits in the fleet: the CPU's vectorised kernels round a row's last bit
  by its place in the batch (the solve of one QP alone at B=1 and at row
  1 of B=3 part by a bit), and the force-balance QP (kappa ~ 1e8,
  tests/test_torch_force_balance.py) turns that bit into 8.5e-3 N of
  force (measured: the Go1 of B=3, with the QP's inputs equal).
"""

import functools

import numpy as np
import pytest
import torch

from fleet_cases import (BATCHES, ROBOTS, assert_rows_equal, cycle, flat,
                         heights, max_err)
from quadruped_tpu_torch.benchmarks import fleet_paths
from quadruped_tpu_torch.control.desired_state import ControlMode, TwistCommand
from quadruped_tpu_torch.control.locomotion import locomotion_step
from quadruped_tpu_torch.gait import named_gait
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots import named_params, stack_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim.rollout import (rollout, rollout_init,
                                             rollout_segment, tick_time)
from quadruped_tpu_torch.utils import tree

torch.set_num_threads(1)

MODES = {"velocity": ControlMode.VELOCITY, "position": ControlMode.POSITION}
TICKS = 40
MG = 13.0 * 9.81
MU = 0.45
SIM_FIELDS = ("position", "quat", "vel_world", "omega_world", "q", "dq",
              "foot_anchor")
# tests/test_torch_locomotion_modes.py's limits.
TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
       "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
       "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-3}


def _summary(res, to_numpy):
    out = {f: to_numpy(getattr(res.sim, f)) for f in SIM_FIELDS}
    for k in ("base_height_trace", "vel_trace", "forces_trace", "alive"):
        out[k] = to_numpy(getattr(res, k))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as jm
    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control import swing as js
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.gait import TROT as JTROT
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim.rollout import rollout as j_rollout

    mode = MODES[name]
    cfg = JLC(mpc=jm.MpcConfig(), swing=js.SwingConfig(mode=mode),
              gait=JTROT(), mode=mode,
              force_balance=jfb.ForceBalanceConfig())
    res = jax.jit(jax.vmap(lambda p, v, h: j_rollout(
        cfg, p, JTC.constant(vx=v, body_height=h), steps=TICKS)))(
        j_stack(ROBOTS), jnp.asarray(fleet_paths.speeds(name, len(ROBOTS))),
        jnp.asarray(heights(ROBOTS)))
    return _summary(res, np.asarray)


def _port_run(name):
    res = rollout(fleet_paths.locomotion_config(name, "cpu"),
                  stack_params(ROBOTS, "cpu"),
                  TwistCommand.constant(vx=fleet_paths.speeds(name,
                                                              len(ROBOTS)),
                                        body_height=heights(ROBOTS),
                                        device="cpu"), TICKS)
    return _summary(res, lambda t: t.numpy())


def _missed(forces):
    """A tick whose forces leave a leg's friction pyramid or pull on the
    ground (a polish miss), with 0.5 N of slack."""
    fz = forces[..., 2]
    ft = np.max(np.abs(forces[..., :2]), axis=-1)
    return np.any((fz < -0.5) | (ft > MU * np.maximum(fz, 0.0) + 0.5),
                  axis=-1)


@pytest.mark.parametrize("name", list(MODES))
def test_fleet_rollout_matches_jax(name):
    got, want = _port_run(name), _jax_run(name)
    np.testing.assert_array_equal(got["alive"], want["alive"])
    assert got["alive"].min() == 1.0
    for key, tol in TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert max_err(got[key], want[key]) <= tol, key
    held = ~(_missed(got["forces_trace"]) | _missed(want["forces_trace"]))
    assert held.mean() >= 0.98
    err = np.abs(got["forces_trace"] - want["forces_trace"]).max((-1, -2))
    assert err[held].max() <= 0.01 * MG, err[held].max()


def _step_outputs(config, params, carry, cmd, t):
    obs = srb_sim.observe(params, carry.sim,
                          stance_contact_mask(carry.ctrl.gait))
    command, forces, ctrl = locomotion_step(config, params, carry.ctrl, obs,
                                            cmd, t)
    stance = stance_contact_mask(ctrl.gait)
    sim = srb_sim.srb_sim_step(
        params, carry.sim, forces, stance, command.q, command.dq,
        1.0 - torch.repeat_interleave(stance, 3, dim=-1), 0.002)
    return flat(command=command, forces=forces, ctrl=ctrl, obs=obs, sim=sim)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", list(MODES))
def test_fleet_step_equals_each_robot_alone(name, batch):
    import dataclasses

    names = cycle(batch)
    gaits = [("trot", "bound", "pace")[i % 3] for i in range(batch)]
    rng = np.random.default_rng(batch)
    cmd = TwistCommand.constant(
        vx=(0.1 + 0.3 * rng.random(batch)).astype(np.float32),
        wz=(0.2 * rng.standard_normal(batch)).astype(np.float32),
        body_height=heights(names), device="cpu")
    base = fleet_paths.locomotion_config(name, "cpu")

    def config(gait):
        return dataclasses.replace(base, gait=gait)

    params = stack_params(names, "cpu")
    fleet_cfg = config(tree.stack([named_gait(g, "cpu") for g in gaits]))
    carry, _ = rollout_segment(fleet_cfg, params, cmd,
                               rollout_init(fleet_cfg, params, batch), 12)
    t = np.float32(13) * np.float32(0.002)
    fleet = _step_outputs(fleet_cfg, params, carry, cmd,
                          tick_time(t, batch, "cpu"))
    alone = [_step_outputs(config(named_gait(gaits[i], "cpu")),
                           named_params(names[i], "cpu"), carry, cmd,
                           tick_time(t, batch, "cpu"))
             for i in range(batch)]
    assert_rows_equal(fleet, alone, names)
