"""The MPC's command-preview channel (`v_preview`, `z_preview` of
`locomotion_step`) of the port against the JAX package (CPU).

The schedules are those of tests/test_long_horizon_closed_loop.py: the
scheduled stop (cruise at 0.5 m/s, then 0) of
`test_h16_preview_transition_beats_h10` and the scheduled crouch (0.27 ->
0.22 m over 0.3 s) of `test_height_preview_crouch`, each moved in time so
that it changes inside a 30-tick closed loop on the SRB sim from the
boot: the stop falls on tick 15, the crouch's ramp starts on tick 10.
Both packages run the loop at H=10 (`MpcConfig(horizon=10,
qp_cold_iters=400)`) and at `long_horizon_config(qp_cold_iters=400)`
(H=16), each tick's command and preview the schedule's.

Held: the stance forces of every tick within 1% m*g (the tolerance of
tests/test_torch_move_blocking.py::test_mpc_solve_matches_jax: the
Newton-Schulz rounding the warm ADMM carries), and the desired trajectory
of every MPC solve of the port's run, given to the JAX
`mpc._desired_trajectory` on the same inputs, within 1e-6 (float32
roundoff of the cumulative sum).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu_torch.control import mpc as t_mpc
from quadruped_tpu_torch.control import swing as t_swing
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils.convert import as_numpy

torch.set_num_threads(1)

DT, TICKS = 0.002, 30
MG = 13.0 * 9.81
FORCE_TOL = 0.01 * MG
TRAJ_TOL = 1e-6
# The JAX tests' schedules, moved so their change falls inside the run.
V, T_STOP = 0.5, 4.0
STOP_SHIFT = T_STOP - 15 * DT
CROUCH_SHIFT = 2.5 - 10 * DT
HORIZONS = ("h10", "h16")
CHANNELS = ("v_preview", "z_preview")


def _mpc_kw(horizon: str) -> dict:
    return (dict(horizon=10, qp_cold_iters=400) if horizon == "h10" else
            dict(horizon=16, move_block=(4, 2), force_weight=1e-4,
                 qp_cold_iters=400))


def stop_profile(t):
    """The scheduled stop of test_h16_preview_transition_beats_h10."""
    return np.where(np.asarray(t) + STOP_SHIFT < T_STOP, V, 0.0
                    ).astype(np.float32)


def crouch_profile(t):
    """The scheduled crouch of test_height_preview_crouch."""
    t = np.asarray(t) + CROUCH_SHIFT
    ramp = np.clip((t - 2.5) / 0.3, 0.0, 1.0) * np.clip((4.0 - t) / 0.3,
                                                        0.0, 1.0)
    return (0.27 - 0.05 * np.clip(ramp, 0.0, 1.0)).astype(np.float32)


def schedule(channel: str, h: int, dt_mpc: float) -> dict:
    """Per tick (t of tick i: (i + 1) DT in float32): the command's vx and
    body height [T], and the preview [T, H] at t + k dt_mpc."""
    t = (np.arange(1, TICKS + 1, dtype=np.float32) * np.float32(DT))
    ahead = t[:, None] + np.arange(h, dtype=np.float32) * np.float32(dt_mpc)
    if channel == "v_preview":
        return {"t": t, "vx": stop_profile(t),
                "height": np.full(TICKS, 0.27, np.float32),
                "preview": stop_profile(ahead)}
    return {"t": t, "vx": np.full(TICKS, 0.2, np.float32),
            "height": crouch_profile(t), "preview": crouch_profile(ahead)}


@functools.lru_cache(maxsize=None)
def jax_forces(horizon: str, channel: str) -> np.ndarray:
    """[T, 4, 3] stance forces of the JAX closed loop, written as the JAX
    tests write it (`jax.lax.scan` of locomotion_step -> srb_sim_step)."""
    from quadruped_tpu.control import swing
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import (LocomotionConfig as JLC,
                                                  locomotion_init as jinit,
                                                  locomotion_step as jstep,
                                                  stance_contact_mask as jsc)
    from quadruped_tpu.control.mpc import MpcConfig
    from quadruped_tpu.gait import ADVANCED_TROT as JAT
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import srb_sim as jsim

    params = ja1()
    cfg = MpcConfig(**_mpc_kw(horizon))
    config = JLC(mpc=cfg, swing=swing.SwingConfig(), gait=JAT())
    sched = schedule(channel, cfg.horizon, cfg.dt_mpc)
    sim0 = jsim.srb_sim_init(params)
    ctrl0 = jinit(config, params,
                  jsim.observe(params, sim0, jnp.ones(4, jnp.float32)))

    def step(carry, x):
        sim, ctrl = carry
        t, vx, height, preview = x
        obs = jsim.observe(params, sim, jsc(ctrl.gait))
        cmd = JTC.constant(body_height=0.27).replace(
            linear=jnp.stack([vx, jnp.zeros(()), jnp.zeros(())]),
            body_height=height)
        kw = {channel: preview}
        command, forces, ctrl = jstep(config, params, ctrl, obs, cmd, t,
                                      **kw)
        stance = jsc(ctrl.gait)
        sim = jsim.srb_sim_step(params, sim, forces, stance, command.q,
                                command.dq, 1.0 - jnp.repeat(stance, 3), DT)
        return (sim, ctrl), forces

    xs = tuple(jnp.asarray(sched[k])
               for k in ("t", "vx", "height", "preview"))
    _, forces = jax.jit(lambda: jax.lax.scan(step, (sim0, ctrl0), xs))()
    return np.asarray(forces)


@functools.lru_cache(maxsize=None)
def port_run(horizon: str, channel: str):
    """(forces [T, 4, 3], the arguments and result of every
    `_desired_trajectory` call) of the port's closed loop."""
    params = a1_params("cpu")
    cfg = t_mpc.MpcConfig(**_mpc_kw(horizon))
    config = LocomotionConfig(mpc=cfg, swing=t_swing.SwingConfig(),
                              gait=ADVANCED_TROT("cpu"))
    sched = schedule(channel, cfg.horizon, cfg.dt_mpc)
    sim = srb_sim.srb_sim_init(params, 1)
    ctrl = locomotion_init(config, params,
                           srb_sim.observe(params, sim, torch.ones(1, 4)))
    calls = []
    original = t_mpc._desired_trajectory

    def spy(*args):
        out = original(*args)
        calls.append((args, out))
        return out

    t_mpc._desired_trajectory = spy
    forces = []
    try:
        for i in range(TICKS):
            obs = srb_sim.observe(params, sim, stance_contact_mask(ctrl.gait))
            cmd = TwistCommand.constant(vx=sched["vx"][i],
                                        body_height=sched["height"][i],
                                        device="cpu")
            kw = {channel: torch.as_tensor(sched["preview"][i:i + 1])}
            t = torch.as_tensor(sched["t"][i:i + 1])
            command, f, ctrl = locomotion_step(config, params, ctrl, obs,
                                               cmd, t, **kw)
            stance = stance_contact_mask(ctrl.gait)
            sim = srb_sim.srb_sim_step(
                params, sim, f, stance, command.q, command.dq,
                1.0 - torch.repeat_interleave(stance, 3, dim=-1), DT)
            forces.append(f[0].numpy())
    finally:
        t_mpc._desired_trajectory = original
    return np.stack(forces), calls


def jax_trajectory(horizon: str, args) -> np.ndarray:
    """The JAX `_desired_trajectory` on the port's arguments of one call
    (jax.vmap over the scenario axis)."""
    from quadruped_tpu.control import mpc as j_mpc
    from quadruped_tpu.control.desired_state import DesiredStateCommand
    from quadruped_tpu.control.types import RobotObservation

    _, state, obs, des, rpy_comp, body_height, vp, zp = args
    j_state = j_mpc.MpcState(**{k: jnp.asarray(v) for k, v in
                                as_numpy(state).items()})
    j_obs = RobotObservation(**{k: jnp.asarray(v) for k, v in
                                as_numpy(obs).items()})
    j_des = DesiredStateCommand(**{k: jnp.asarray(v) for k, v in
                                   as_numpy(des).items()})
    cfg = j_mpc.MpcConfig(**_mpc_kw(horizon))
    preview = [None if p is None else jnp.asarray(p.numpy())
               for p in (vp, zp)]
    axes = tuple(None if p is None else 0 for p in preview)

    def one(s, o, d, r, h, v, z):
        return j_mpc._desired_trajectory(cfg, s, o, d, r, h, v, z)

    fn = jax.vmap(one, in_axes=(0, 0, 0, 0, 0) + axes)
    return np.asarray(fn(j_state, j_obs, j_des, jnp.asarray(rpy_comp.numpy()),
                         jnp.asarray(body_height.numpy()), *preview))


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("horizon", HORIZONS)
def test_preview_forces_match_jax(horizon, channel):
    """The closed loop's stance forces, tick by tick, across the change of
    the schedule."""
    got, _ = port_run(horizon, channel)
    want = jax_forces(horizon, channel)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= FORCE_TOL, (err, FORCE_TOL)


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("horizon", HORIZONS)
def test_preview_trajectory_matches_jax(horizon, channel):
    """Every MPC solve's desired trajectory, port and JAX on the same
    inputs; the preview reaches it (the rows it sets change along the
    horizon) and the solves fall on the MPC cadence."""
    _, calls = port_run(horizon, channel)
    cfg = t_mpc.MpcConfig(**_mpc_kw(horizon))
    assert len(calls) == -(-TICKS // cfg.ticks_per_solve)
    rows = [5] if channel == "z_preview" else [9]
    seen = []
    for args, out in calls:
        assert (args[6] is None) == (channel == "z_preview")
        want = jax_trajectory(horizon, args)
        err = np.abs(out.numpy() - want).max()
        assert err <= TRAJ_TOL, (err, TRAJ_TOL)
        seen.append(out[0, :, rows].numpy())
    assert np.ptp(np.stack(seen)) > 0.01
