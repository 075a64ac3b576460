"""Fleets through the whole-body model, the WBC and the whole-body closed
loop on the port, against the JAX package and against each robot alone
(CPU).

* `build_model` of a fleet of the five robots against `jax.vmap` of the
  JAX `build_model` over its `stack_params`, field by field within
  MODEL_TOL (the Lite3's and Lite2's one-robot models already differ from
  JAX's in the last bit, 1.5e-11 of an inertia entry, where m c c^T sums
  in another order; the A1's, Go1's and Aliengo's are equal), equal to
  each robot's one-robot model, and carried across by `to_torch` with
  its fleet axis; then `mass_matrix`, the gravity and
  Coriolis forces, `contact_jacobians` and `forward_dynamics` on the [B]
  model and random states against `jax.vmap` of the JAX functions over
  (model, state), at tests/test_torch_whole_body.py's limits (TOL there;
  CPU readings in FB_TOL below).
* `rollout` with `use_wbc` (`MpcConfig(horizon=5, qp_iters=40)`,
  `WbcConfig()`) of the fleet, resumed from JAX's boot carry (`to_torch`
  of the JAX `rollout_init` under `jax.vmap`: the MPC cold start was
  JAX's), WBC_TICKS ticks against JAX's, at tests/test_torch_wbc.py's
  limits (WBC_TOL, CPU readings beside it).
* The whole-body closed loop (benchmarks/whole_body.py's tick,
  `MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120)`) of the five
  robots, resumed from JAX's boot state (the `WholeBodySimState` and the
  `LocomotionState` with their fleet axis), LOOP_TICKS ticks against
  JAX's, at tests/test_torch_whole_body.py's CLOSED_TOL (CPU readings
  beside it). The loop starts with the feet 3-5 cm into the ground and is
  chaotic. The Lite2, lightest of the five, parts from JAX the most
  (3.3e-4 m of height in 40 ticks, the A1 4e-7): the two packages' bf16
  Newton-Schulz steps round their sums apart, and its loop amplifies that
  most (tests/test_torch_lite2_whole_body.py).
* One tick of a fleet (robots cycling, vx from a seed) against each
  scenario run with its one-robot parameters and model, at B = 3, 4, 5
  and 12: a WBC tick of the `use_wbc` rollout, and a whole-body tick that
  solves the MPC (K1's path on the card). Equal to float32 rounding
  (tests/test_torch_fleet_modes.py's method, each scenario read at its
  own row).
"""

import functools

import numpy as np
import pytest
import torch

from fleet_cases import (BATCHES, ROBOTS, assert_rows_equal, cycle, flat,
                         heights, max_err)
from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control import wbc as wbc_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    LocomotionState,
                                                    locomotion_step)
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots import named_params, stack_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.sim.rollout import (RolloutCarry, rollout_init,
                                             rollout_segment, tick_time)
from quadruped_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

DT = 0.002
MG = 13.0 * 9.81
# Fleet model vs jax.vmap(build_model), max |diff| (CPU: 1.5e-11).
MODEL_TOL = 1e-9
FB_FIELDS = ("quat", "position", "omega_body", "vel_body", "q", "dq")
# tests/test_torch_whole_body.py TOL (CPU readings on the fleet; its
# entries are larger than the A1's: the Aliengo's mass matrix reaches
# 21.7, its gravity force 211).
FB_TOL = {"mass_matrix": 1e-6,        # 9.5e-7
          "gravity_force": 5e-5,      # 1.9e-6
          "coriolis_force": 1e-5,     # 9.5e-7
          "jc": 5e-7,                 # 6.0e-8
          "jcdqd": 2e-5,              # 4.8e-7
          "foot_positions_world": 2e-7,   # 3.0e-8
          "forward_dynamics": 5e-3}   # 1.5e-3 (of 3.8e3)
WBC_TICKS = 24
# tests/test_torch_wbc.py TOL (CPU readings on the fleet).
WBC_TOL = {"position": 2e-4,          # 4.8e-6
           "base_height_trace": 2e-4,  # 4.8e-6
           "vel_trace": 5e-3,         # 1.9e-4
           "q": 2e-3,                 # 5.6e-5
           "forces_trace": 0.01 * MG,  # 0.70 N (the Aliengo's m*g: 196 N)
           "tau_trace": 0.3}          # 0.23 N m
LOOP_TICKS = 40
LOOP_ROBOTS = ROBOTS
# tests/test_torch_whole_body.py CLOSED_TOL (CPU readings on the fleet,
# each the Lite2's).
CLOSED_TOL = {"quat": 4e-3,           # 1.5e-3
              "position": 2e-3,       # 3.3e-4
              "omega_body": 0.1,      # 5.9e-2
              "vel_body": 3e-2,       # 6.9e-3
              "q": 4e-2,              # 7.6e-3
              "height_trace": 5e-4,   # 3.3e-4
              "vx_trace": 2e-2}       # 6.8e-3


def _vx(batch: int, seed: int = 0) -> np.ndarray:
    return (0.2 + 0.4 * np.random.default_rng(seed).random(batch)).astype(
        np.float32)


def _rand_fb(batch: int, seed: int) -> dict:
    """Random floating-base states (numpy, field -> [B, ...])."""
    rng = np.random.default_rng(seed)
    rpy = torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, 3)),
                          dtype=torch.float32)
    q = np.concatenate([rng.uniform([-0.4, 0.3, -2.0], [0.4, 1.1, -0.9],
                                    (batch, 3)) for _ in range(4)], axis=1)
    out = dict(quat=se3.rpy_to_quat(rpy).numpy(),
               position=rng.normal(size=(batch, 3)) * 0.1 + [0, 0, 0.3],
               omega_body=rng.normal(size=(batch, 3)) * 0.5,
               vel_body=rng.normal(size=(batch, 3)) * 0.5,
               q=q, dq=rng.normal(size=(batch, 12)) * 2.0)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("field", ["xtree_r", "inertias", "foot_offset"])
def test_fleet_model_equals_jax_vmap(field):
    import jax

    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.robots import stack_params as j_stack

    jmodel = jax.vmap(jfb.build_model)(j_stack(ROBOTS))
    model = fb.build_model(stack_params(ROBOTS, "cpu"))
    got = getattr(model, field)
    assert got.shape[0] == len(ROBOTS)
    assert max_err(got.numpy(), np.asarray(getattr(jmodel, field))) \
        <= MODEL_TOL
    carried = getattr(to_torch(jmodel, fb.FloatingBaseModel,
                               device="cpu"), field)
    assert carried.shape == got.shape
    np.testing.assert_array_equal(carried.numpy(),
                                  np.asarray(getattr(jmodel, field)))
    for i, name in enumerate(ROBOTS):
        assert torch.equal(got[i], getattr(fb.build_model(
            named_params(name, "cpu")), field)), name


def _fb_cases():
    """name -> fn(module, model, state, tau, feet)."""
    return {
        "mass_matrix": lambda m, mod, s, tau, f: mod.mass_matrix(m, s.q),
        "gravity_force": lambda m, mod, s, tau, f: mod.gravity_force(m, s),
        "coriolis_force": lambda m, mod, s, tau, f: mod.coriolis_force(m, s),
        "jc": lambda m, mod, s, tau, f: mod.contact_jacobians(m, s)[0],
        "jcdqd": lambda m, mod, s, tau, f: mod.contact_jacobians(m, s)[1],
        "foot_positions_world": lambda m, mod, s, tau, f:
            mod.foot_positions_world(m, s),
        "forward_dynamics": lambda m, mod, s, tau, f:
            mod.forward_dynamics(m, s, tau, f),
    }


@pytest.mark.parametrize("name", list(FB_TOL))
def test_fleet_model_functions_match_jax(name):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.robots import stack_params as j_stack

    arrays = _rand_fb(len(ROBOTS), 0)
    rng = np.random.default_rng(1)
    tau = rng.normal(size=(len(ROBOTS), 18)).astype(np.float32)
    feet = (rng.normal(size=(len(ROBOTS), 4, 3)) * 30.0).astype(np.float32)
    run = _fb_cases()[name]
    want = jax.jit(jax.vmap(lambda p, s, t, f: run(
        jfb.build_model(p), jfb, s, t, f)))(
        j_stack(ROBOTS), jfb.FbState(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()}),
        jnp.asarray(tau), jnp.asarray(feet))
    model = fb.build_model(stack_params(ROBOTS, "cpu"))
    got = run(model, fb, fb.FbState(**{k: torch.from_numpy(v)
                                        for k, v in arrays.items()}),
              torch.from_numpy(tau), torch.from_numpy(feet))
    assert got.shape == want.shape
    assert max_err(got, want) <= FB_TOL[name]


def _wbc_config(jax_side: bool):
    if jax_side:
        from quadruped_tpu.control import mpc as jm
        from quadruped_tpu.control import swing as js
        from quadruped_tpu.control import wbc as jwbc
        from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
        from quadruped_tpu.gait import ADVANCED_TROT as JAT

        return JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=40),
                   swing=js.SwingConfig(), gait=JAT(),
                   wbc=jwbc.WbcConfig(), use_wbc=True)
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT("cpu"),
                            wbc=wbc_mod.WbcConfig(), use_wbc=True)


@functools.lru_cache(maxsize=None)
def _jax_wbc():
    """JAX's boot carry of the fleet and WBC_TICKS ticks of its use_wbc
    loop (as tests/test_torch_wbc.py runs it, keeping the torques)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import locomotion_step as jstep
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.gait.scheduler import stance_contact_mask as jmask
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim import srb_sim as jsrb
    from quadruped_tpu.sim.rollout import rollout_init as j_init

    cfg = _wbc_config(True)

    def window(p, carry, vx, h):
        cmd = JTC.constant(vx=vx, body_height=h)
        model = jfb.build_model(p)

        def step(c, i):
            sim, ctrl = c
            t = (i + 1).astype(jnp.float32) * DT
            obs = jsrb.observe(p, sim, jmask(ctrl.gait))
            command, forces, ctrl = jstep(cfg, p, ctrl, obs, cmd, t,
                                          model=model)
            stance = jmask(ctrl.gait)
            sim = jsrb.srb_sim_step(p, sim, forces, stance, command.q,
                                    command.dq, 1.0 - jnp.repeat(stance, 3),
                                    DT)
            return (sim, ctrl), (sim.position[2], sim.vel_world, forces,
                                 command.tau)

        (sim, _), tr = jax.lax.scan(step, (carry.sim, carry.ctrl),
                                    jnp.arange(WBC_TICKS))
        return sim, tr

    jp = j_stack(ROBOTS)
    carry = jax.jit(jax.vmap(lambda p: j_init(cfg, p)))(jp)
    sim, tr = jax.jit(jax.vmap(window))(jp, carry,
                                        jnp.asarray(_vx(len(ROBOTS))),
                                        jnp.asarray(heights(ROBOTS)))
    want = dict(zip(("base_height_trace", "vel_trace", "forces_trace",
                     "tau_trace"), (np.asarray(x) for x in tr)))
    want.update(position=np.asarray(sim.position), q=np.asarray(sim.q))
    return carry, want


def test_fleet_wbc_rollout_matches_jax():
    jcarry, want = _jax_wbc()
    carry = to_torch(jcarry, RolloutCarry, device="cpu")
    assert carry.step == 0 and carry.sim.q.shape == (len(ROBOTS), 12)
    cmd = TwistCommand.constant(vx=_vx(len(ROBOTS)),
                                body_height=heights(ROBOTS), device="cpu")
    _, res = rollout_segment(_wbc_config(False),
                             stack_params(ROBOTS, "cpu"), cmd, carry,
                             WBC_TICKS)
    got = {"base_height_trace": res.base_height_trace,
           "vel_trace": res.vel_trace, "forces_trace": res.forces_trace,
           "tau_trace": res.tau_trace, "position": res.sim.position,
           "q": res.sim.q}
    assert res.alive.min().item() == 1.0
    for key, tol in WBC_TOL.items():
        assert torch.isfinite(got[key]).all(), key
        assert max_err(got[key].numpy(), want[key]) <= tol, key


def _loop_config(jax_side: bool):
    kw = dict(horizon=5, qp_iters=24, qp_cold_iters=120)
    if jax_side:
        from quadruped_tpu.control import mpc as jm
        from quadruped_tpu.control import swing as js
        from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
        from quadruped_tpu.gait import ADVANCED_TROT as JAT

        return JLC(mpc=jm.MpcConfig(**kw), swing=js.SwingConfig(),
                   gait=JAT())
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(**kw),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT("cpu"))


@functools.lru_cache(maxsize=None)
def _jax_loop():
    """JAX's boot (the whole-body sim standing, the controller with its
    cold start) of the fleet and LOOP_TICKS ticks of its closed loop."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import (locomotion_init,
                                                  locomotion_step)
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.robots import stack_params as j_stack
    from quadruped_tpu.sim import whole_body as jwb

    cfg = _loop_config(True)
    contact = jwb.ContactModel()

    def boot(p):
        sim = jwb.whole_body_init(p)
        return sim, locomotion_init(cfg, p, jwb.observe(
            p, jfb.build_model(p), sim, contact))

    def window(p, sim, ctrl, vx, h):
        model = jfb.build_model(p)
        cmd = JTC.constant(vx=vx, body_height=h)

        def step(c, i):
            s, k = c
            obs = jwb.observe(p, model, s, contact)
            command, _, k = locomotion_step(cfg, p, k, obs, cmd,
                                            (i + 1).astype(jnp.float32) * DT)
            s, _ = jwb.whole_body_step(p, model, s, command, contact, DT)
            return (s, k), (s.fb.position[2], jwb.observe(
                p, model, s, contact).base_vel_world[0])

        (s, _), (hs, vs) = jax.lax.scan(step, (sim, ctrl),
                                        jnp.arange(LOOP_TICKS))
        return s.fb, hs, vs

    jp = j_stack(LOOP_ROBOTS)
    sim, ctrl = jax.jit(jax.vmap(boot))(jp)
    s, hs, vs = jax.jit(jax.vmap(window))(
        jp, sim, ctrl, jnp.asarray(_vx(len(LOOP_ROBOTS))),
        jnp.asarray(heights(LOOP_ROBOTS)))
    want = {k: np.asarray(getattr(s, k)) for k in FB_FIELDS}
    want.update(height_trace=np.asarray(hs), vx_trace=np.asarray(vs))
    return sim, ctrl, want


def test_fleet_whole_body_loop_matches_jax():
    jsim, jctrl, want = _jax_loop()
    params = stack_params(LOOP_ROBOTS, "cpu")
    loop = bench_wb.Loop(
        _loop_config(False), params, fb.build_model(params),
        wb.ContactModel(),
        TwistCommand.constant(vx=_vx(len(LOOP_ROBOTS)),
                              body_height=heights(LOOP_ROBOTS),
                              device="cpu"),
        to_torch(jsim, wb.WholeBodySimState, device="cpu"),
        to_torch(jctrl, LocomotionState, device="cpu"))
    loop, (h, v) = bench_wb.run(loop, LOOP_TICKS)
    got = {k: getattr(loop.sim.fb, k).numpy() for k in FB_FIELDS}
    got.update(height_trace=h.numpy(), vx_trace=v.numpy())
    for key, tol in CLOSED_TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert max_err(got[key], want[key]) <= tol, key
    assert np.all(got["height_trace"] > 0.2)


def _wbc_tick(config, params, carry, cmd, t):
    obs = srb_sim.observe(params, carry.sim,
                          stance_contact_mask(carry.ctrl.gait))
    command, forces, ctrl = locomotion_step(config, params, carry.ctrl, obs,
                                            cmd, t,
                                            model=fb.build_model(params))
    return flat(command=command, forces=forces, ctrl=ctrl)


def _wb_tick(loop, params):
    model = fb.build_model(params)
    obs = wb.observe(params, model, loop.sim, loop.contact)
    t = tick_time(np.float32(loop.step + 1) * np.float32(DT),
                  obs.base_position.shape[0], "cpu")
    command, forces, ctrl = locomotion_step(loop.config, params, loop.ctrl,
                                            obs, loop.cmd, t)
    sim, flags = wb.whole_body_step(params, model, loop.sim, command,
                                    loop.contact, DT)
    return flat(command=command, forces=forces, ctrl=ctrl, obs=obs, sim=sim,
                flags=flags)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("path", ["wbc", "whole_body"])
def test_fleet_tick_equals_each_robot_alone(path, batch):
    names = cycle(batch)
    params = stack_params(names, "cpu")
    vx = _vx(batch, seed=batch)
    if path == "wbc":
        config = _wbc_config(False)
        cmd = TwistCommand.constant(vx=vx, body_height=heights(names),
                                    device="cpu")
        # 10 ticks in: a WBC tick (even, and no MPC solve).
        carry, _ = rollout_segment(config, params, cmd,
                                   rollout_init(config, params, batch), 10)
        assert int(carry.ctrl.wbc_iteration[0]) % 2 == 0
        t = tick_time(np.float32(11) * np.float32(DT), batch, "cpu")
        fleet = _wbc_tick(config, params, carry, cmd, t)
        alone = [_wbc_tick(config, named_params(n, "cpu"), carry, cmd, t)
                 for n in names]
    else:
        loop = bench_wb.build(batch, "cpu", _loop_config(False), vx, params,
                              heights(names))
        # 8 ticks in: the tick solves the MPC.
        loop, _ = bench_wb.run(loop, 8)
        assert int(loop.ctrl.mpc.iteration[0]) % 8 == 0
        fleet = _wb_tick(loop, params)
        alone = [_wb_tick(loop, named_params(n, "cpu")) for n in names]
    assert_rows_equal(fleet, alone, names)
