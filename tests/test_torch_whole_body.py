"""The port's whole-body fidelity modules against the JAX package:
dynamics/spatial.py, dynamics/floating_base.py, sim/terrain.py,
sim/whole_body.py and the whole-body closed loop
(quadruped_tpu_torch/benchmarks/whole_body.py, the twin of the JAX
benchmarks/bench_whole_body.py loop).

* Function by function on the same inputs (numpy seeds), B = 8: the port
  against the JAX function (`jax.vmap`-batched where the JAX function is
  written for one robot). Tolerances are max |diff| over the batch, stated
  in TOL with the value measured on this CPU beside each; float32
  arithmetic in two summation orders, nothing else.
* One whole-body step, then 50 ticks under a fixed stand command (no
  controller), against JAX.
* The closed loop (4 scenarios, 150 ticks, `MpcConfig(horizon=5,
  qp_iters=24, qp_cold_iters=120)`) against JAX and against the fixture
  tests/data/whole_body_a1.npz (JAX's output, which chip_smoke.py holds the
  card to). The stiff contact (k = 8000 N/m) makes the loop chaotic: moving
  JAX's own start height by 3e-8 m (one float32 step) moves its height
  trace by 6.1e-5 m, its forward speed by 1.4e-3 m/s and its joint speeds
  by 3.8 rad/s within 150 ticks (the first two held by
  `test_port_differs_from_jax_as_jax_from_itself`). So the traces are held
  over the 150 ticks (height 5e-4 m, measured 1.4e-4; vx 2e-2 m/s,
  measured 5.2e-3), the final pose loosely (CLOSED_TOL), and the joint
  speeds not at all.

The twins of the JAX physical checks are in
tests/test_torch_whole_body_physics.py.

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_whole_body.py
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import whole_body as twb
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.control.types import HybridCommand
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.dynamics import spatial as sp
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import terrain
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils.convert import to_torch

FIXTURE = Path(__file__).parent / "data" / "whole_body_a1.npz"
B = 8
DT = 0.002
# Closed loop: forward speeds of the 4 scenarios and the ticks.
LOOP_VX = [0.2, 0.3, 0.45, 0.6]
LOOP_TICKS = 150
FB_FIELDS = ("quat", "position", "omega_body", "vel_body", "q", "dq")
# max |port - JAX| (measured on this CPU).
TOL = {
    "spatial": 5e-7,            # 6.0e-8 (joint transforms), else <= 7.5e-9
    "mass_matrix": 1e-6,        # 1.3e-7 (entries up to 13.5)
    "gravity_force": 5e-5,      # 7.6e-6 (up to 131)
    "coriolis_force": 1e-5,     # 1.3e-6 (up to 7.4)
    "foot_positions_world": 2e-7,   # 3.0e-8
    "jc": 5e-7,                 # 6.0e-8
    "jcdqd": 2e-5,              # 1.9e-6 (up to 11.5)
    "world_positions": 2e-7,    # 3.0e-8
    "world_rotations": 1e-6,    # 1.2e-7
    "inverse_dynamics": 1e-4,   # 7.6e-6 (up to 145)
    # Random torques on 0.2 kg links give accelerations up to 2.1e3;
    # relative to that the difference is 3.7e-7.
    "forward_dynamics": 5e-3,   # 7.9e-4 (feet), 2.1e-4 (none, of 664)
    "terrain": 1e-6,            # 0
    "contact_forces": 1e-3,     # 2.8e-4 N (up to 1.7e3 N)
}
# One step (2 substeps) from random states under random commands.
STEP_TOL = {"quat": 1e-7, "position": 1e-7, "omega_body": 5e-5,
            "vel_body": 5e-7, "q": 1e-6, "dq": 1e-4}
# Measured: 1.5e-8, 0, 8.1e-6 (of 6.6), 6.0e-8, 1.2e-7, 1.8e-5 (of 55).
# 50 ticks of the sim alone under the stand command, dropped from 0.28 to
# 0.35 m with the joints off their stand angles: the touchdown amplifies
# rounding as the closed loop does (moving JAX's start heights by 3e-8 m
# moves its own result by 3.1e-5, 4.5e-6, 1.6e-3, 1.4e-4, 6.3e-5, 2.1e-2
# in the fields below).
STAND_TOL = {"quat": 1e-4, "position": 2e-5, "omega_body": 1.5e-2,
             "vel_body": 1e-3, "q": 4e-4, "dq": 0.2}
# Measured: 1.5e-5, 2.3e-6, 3.1e-3, 1.4e-4, 7.2e-5, 4.5e-2 (of 3.7).
# The closed loop after 150 ticks (final pose) and over its traces.
CLOSED_TOL = {"quat": 4e-3, "position": 2e-3, "omega_body": 0.1,
              "vel_body": 3e-2, "q": 4e-2, "height_trace": 5e-4,
              "vx_trace": 2e-2}
# Measured: 9.2e-4, 5.7e-4, 2.9e-2, 7.8e-3, 9.4e-3, 1.4e-4, 5.2e-3.


def _jax():
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.robots import a1_params as ja1

    params = ja1()
    return params, jfb.build_model(params)


def _rand_fb(seed, batch=B, zero_vel=False, height=0.3):
    """Random floating-base states as numpy arrays (field -> [B, ...])."""
    rng = np.random.default_rng(seed)
    rpy = torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, 3)), dtype=torch.float32)
    q = np.concatenate([rng.uniform([-0.4, 0.3, -2.0], [0.4, 1.1, -0.9],
                                    (batch, 3)) for _ in range(4)], axis=1)
    scale = 0.0 if zero_vel else 1.0
    out = dict(quat=se3.rpy_to_quat(rpy).numpy(),
               position=rng.normal(size=(batch, 3)) * 0.1 + [0, 0, height],
               omega_body=rng.normal(size=(batch, 3)) * 0.5 * scale,
               vel_body=rng.normal(size=(batch, 3)) * 0.5 * scale,
               q=q, dq=rng.normal(size=(batch, 12)) * 2.0 * scale)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _fb_pair(arrays):
    from quadruped_tpu.dynamics import floating_base as jfb

    jstate = jfb.FbState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jstate, to_torch(jstate, fb.FbState)


def _max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


# ---------------------------------------------------------------- spatial

def _spatial_inputs():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    a = rng.normal(size=(B, 3, 3))
    return dict(
        e=np.asarray(se3.rpy_to_rotmat(torch.as_tensor(rpy)).numpy()),
        r=rng.normal(size=(B, 3)).astype(np.float32),
        v=rng.normal(size=(B, 6)).astype(np.float32),
        m=rng.normal(size=(B, 6)).astype(np.float32),
        theta=rng.uniform(-2, 2, B).astype(np.float32),
        mass=rng.uniform(0.1, 3.0, B).astype(np.float32),
        com=(rng.normal(size=(B, 3)) * 0.05).astype(np.float32),
        i_com=(a @ np.swapaxes(a, 1, 2) * 0.01
               + np.eye(3) * 1e-3).astype(np.float32))


SPATIAL_CASES = {
    "spatial_transform": lambda mod, x: mod.spatial_transform(x["e"], x["r"]),
    "transform_inverse": lambda mod, x: mod.transform_inverse(
        mod.spatial_transform(x["e"], x["r"])),
    "rotation_part": lambda mod, x: mod.rotation_part(
        mod.spatial_transform(x["e"], x["r"])),
    "translation_part": lambda mod, x: mod.translation_part(
        mod.spatial_transform(x["e"], x["r"])),
    "motion_cross_matrix": lambda mod, x: mod.motion_cross_matrix(x["v"]),
    "force_cross_matrix": lambda mod, x: mod.force_cross_matrix(x["v"]),
    "motion_cross": lambda mod, x: mod.motion_cross(x["v"], x["m"]),
    "force_cross": lambda mod, x: mod.force_cross(x["v"], x["m"]),
    "joint_transform_x": lambda mod, x: mod.joint_transform_revolute(
        0, x["theta"]),
    "joint_transform_y": lambda mod, x: mod.joint_transform_revolute(
        1, x["theta"]),
    "joint_transform_z": lambda mod, x: mod.joint_transform_revolute(
        2, x["theta"]),
    "joint_motion_subspace": lambda mod, x: np.stack([
        np.asarray(mod.joint_motion_subspace(a)) for a in range(3)]),
    "spatial_inertia": lambda mod, x: mod.spatial_inertia(
        x["mass"], x["com"], x["i_com"]),
    "flip_inertia_along_y": lambda mod, x: np.concatenate([
        np.asarray(t).reshape(B, -1) for t in mod.flip_inertia_along_y(
            x["mass"], x["com"], x["i_com"])], axis=-1),
}


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_matches_jax(name):
    from quadruped_tpu.dynamics import spatial as jsp

    x = _spatial_inputs()
    want = SPATIAL_CASES[name](jsp, {k: jnp.asarray(v) for k, v in x.items()})
    got = SPATIAL_CASES[name](sp, {k: torch.as_tensor(v)
                                   for k, v in x.items()})
    assert _max_err(got, want) <= TOL["spatial"]


# --------------------------------------------------------- floating base

def _fb_cases():
    """name -> (JAX function of (model, state, extra), port function)."""
    from quadruped_tpu.dynamics import floating_base as jfb

    def both(fn_name, pick=None, *extra):
        def run(mod, model, state, ex):
            out = getattr(mod, fn_name)(model, state, *[ex[k] for k in extra])
            return out if pick is None else out[pick]
        return run

    def rotpos(index):
        """[B, 13, ...]: JAX stacks per robot under vmap, the port on dim 1."""
        def run(mod, model, state, ex):
            if mod is fb:
                return torch.stack(fb.world_rotations_positions(
                    model, state)[index], dim=1)
            return jnp.stack(jfb._world_rotations_positions(model,
                                                            state)[index])
        return run

    return {
        "mass_matrix": lambda mod, m, s, ex: mod.mass_matrix(m, s.q),
        "gravity_force": both("gravity_force"),
        "coriolis_force": both("coriolis_force"),
        "foot_positions_world": both("foot_positions_world"),
        "jc": both("contact_jacobians", 0),
        "jcdqd": both("contact_jacobians", 1),
        "world_rotations": rotpos(0),
        "world_positions": rotpos(1),
        "inverse_dynamics": both("inverse_dynamics", None, "qdd"),
        "forward_dynamics": lambda mod, m, s, ex: mod.forward_dynamics(
            m, s, ex["tau"], ex["feet"]),
        "forward_dynamics_no_feet": lambda mod, m, s, ex:
            mod.forward_dynamics(m, s, ex["tau"]),
    }


@pytest.mark.parametrize("name", ["mass_matrix", "gravity_force",
                                  "coriolis_force", "foot_positions_world",
                                  "jc", "jcdqd", "world_rotations",
                                  "world_positions", "inverse_dynamics",
                                  "forward_dynamics",
                                  "forward_dynamics_no_feet"])
def test_floating_base_matches_jax(name):
    from quadruped_tpu.dynamics import floating_base as jfb

    _, jmodel = _jax()
    tmodel = fb.build_model(a1_params("cpu"))
    jstate, tstate = _fb_pair(_rand_fb(0))
    rng = np.random.default_rng(1)
    extra = dict(qdd=rng.normal(size=(B, 18)), tau=rng.normal(size=(B, 18)),
                 feet=rng.normal(size=(B, 4, 3)) * 30.0)
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    run = _fb_cases()[name]
    want = jax.jit(jax.vmap(lambda s, ex: run(jfb, jmodel, s, ex)))(
        jstate, {k: jnp.asarray(v) for k, v in extra.items()})
    got = run(fb, tmodel, tstate, {k: torch.as_tensor(v)
                                   for k, v in extra.items()})
    assert got.shape == want.shape
    tol = TOL[name.replace("_no_feet", "")]
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("field", ["xtree_r", "inertias", "foot_offset"])
def test_build_model_matches_jax(field):
    """Exactly the JAX model, and what `to_torch` carries across."""
    _, jmodel = _jax()
    tmodel = fb.build_model(a1_params("cpu"))
    np.testing.assert_array_equal(getattr(tmodel, field).numpy(),
                                  np.asarray(getattr(jmodel, field)))
    carried = to_torch(jmodel, fb.FloatingBaseModel)
    assert torch.equal(getattr(carried, field), getattr(tmodel, field))


def test_model_per_scenario_equals_shared():
    """A model with a leading scenario axis gives what the shared one
    gives (the JAX pytree is batchable across robots)."""
    shared = fb.build_model(a1_params("cpu"))
    per = fb.FloatingBaseModel(*(getattr(shared, f.name).expand(
        (B,) + getattr(shared, f.name).shape)
        for f in dataclasses.fields(shared)))
    _, state = _fb_pair(_rand_fb(2))
    tau = torch.as_tensor(np.random.default_rng(3).normal(size=(B, 18)),
                          dtype=torch.float32)
    for fn in (lambda m: fb.mass_matrix(m, state.q),
               lambda m: fb.contact_jacobians(m, state)[0],
               lambda m: fb.forward_dynamics(m, state, tau)):
        torch.testing.assert_close(fn(per), fn(shared), rtol=0, atol=0)


# ---------------------------------------------------------------- terrain

TERRAINS = {
    "plane": dict(height=0.05),
    "slope": dict(pitch=0.15, height=0.01),
    "stairs": dict(step_length=0.25, step_height=0.06, start_x=0.5),
    "gaps": dict(gap_centers=(1.0, 1.6), gap_width=0.12, depth=0.5),
    "rough": dict(amplitude=0.02, wavelength=0.3),
}


@pytest.mark.parametrize("name", list(TERRAINS))
def test_terrain_matches_jax(name):
    """Each height field on 8 x 4 points in [-0.5, 2.5] x [-0.5, 0.5],
    shared parameters, and through `named`."""
    from quadruped_tpu.sim import terrain as jterrain

    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 2.5, (B, 4)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (B, 4)).astype(np.float32)
    kind = getattr(terrain.TerrainType, name.upper())
    want = np.asarray(jterrain.named(kind, **TERRAINS[name])(
        jnp.asarray(x), jnp.asarray(y)))
    got = terrain.named(kind, **TERRAINS[name])(torch.as_tensor(x),
                                                torch.as_tensor(y))
    assert got.shape == want.shape
    assert _max_err(got, want) <= TOL["terrain"]


def test_terrain_parameters_per_scenario():
    """A [B] parameter gives scenario b the field of parameter b (JAX: one
    closure per scenario under vmap)."""
    from quadruped_tpu.sim import terrain as jterrain

    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 2.0, (B, 4)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (B, 4)).astype(np.float32)
    pitch = rng.uniform(0.0, 0.3, B).astype(np.float32)
    centers = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    for port, ref in [
            (terrain.slope(pitch=torch.as_tensor(pitch)),
             lambda p, c, xx, yy: jterrain.slope(pitch=p)(xx, yy)),
            (terrain.gaps(gap_centers=torch.as_tensor(centers)),
             lambda p, c, xx, yy: jterrain.gaps(gap_centers=c)(xx, yy))]:
        want = jax.vmap(ref)(jnp.asarray(pitch), jnp.asarray(centers),
                             jnp.asarray(x), jnp.asarray(y))
        got = port(torch.as_tensor(x), torch.as_tensor(y))
        assert _max_err(got, want) <= TOL["terrain"]


# ------------------------------------------------------- sim, one step

def _command_arrays(seed, batch=B):
    rng = np.random.default_rng(seed)
    params = a1_params("cpu")
    out = dict(q=params.stand_angles.numpy() + rng.normal(size=(batch, 12))
               * 0.1,
               kp=np.full((batch, 12), 100.0), dq=rng.normal(size=(batch, 12)),
               kd=np.full((batch, 12), 2.0),
               tau=rng.normal(size=(batch, 12)) * 3.0)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _drop_fb(batch=B):
    """Upright robots at rest, 0.28-0.35 m up, joints N(0, 0.05) off the
    stand angles."""
    rng = np.random.default_rng(9)
    quat = np.zeros((batch, 4))
    quat[:, 0] = 1.0
    position = np.zeros((batch, 3))
    position[:, 2] = np.linspace(0.28, 0.35, batch)
    q = a1_params("cpu").stand_angles.numpy() + rng.normal(
        size=(batch, 12)) * 0.05
    out = dict(quat=quat, position=position, omega_body=np.zeros((batch, 3)),
               vel_body=np.zeros((batch, 3)), q=q, dq=np.zeros((batch, 12)))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _stand_arrays(batch):
    params = a1_params("cpu")
    return dict(q=np.tile(params.stand_angles.numpy(), (batch, 1)),
                kp=np.full((batch, 12), 100.0, np.float32),
                dq=np.zeros((batch, 12), np.float32),
                kd=np.full((batch, 12), 2.0, np.float32),
                tau=np.zeros((batch, 12), np.float32))


@functools.lru_cache(maxsize=None)
def _jax_step_fn(steps: int):
    """jit(vmap) of `steps` JAX whole_body_step ticks from (state, cmd)."""
    from quadruped_tpu.sim import whole_body as jwb

    params, model = _jax()
    contact = jwb.ContactModel()

    def one(s, c):
        def body(sim, _):
            sim, flags = jwb.whole_body_step(params, model, sim, c, contact,
                                             DT)
            return sim, flags

        sim, flags = jax.lax.scan(body, jwb.WholeBodySimState(
            fb=s, t=jnp.zeros(())), None, length=steps)
        return sim.fb, flags[-1]

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=None)
def _jax_steps(steps: int, stand: bool, dh: float = 0.0):
    """JAX whole_body_step, `steps` ticks: from the random near-ground
    states of seed 6 under the seed-7 command, or with `stand` from
    `_drop_fb` under the stand command; the start heights raised by dh."""
    from quadruped_tpu.control.types import HybridCommand as JHC

    states = _drop_fb() if stand else _rand_fb(6, height=0.27)
    states["position"][:, 2] += np.float32(dh)
    cmd = _stand_arrays(B) if stand else _command_arrays(7)
    jstate, _ = _fb_pair(states)
    jcmd = JHC(**{k: jnp.asarray(v) for k, v in cmd.items()})
    out, flags = _jax_step_fn(steps)(jstate, jcmd)
    return ({k: np.asarray(getattr(out, k)) for k in FB_FIELDS},
            np.asarray(flags))


@functools.lru_cache(maxsize=None)
def _port_steps(steps: int, stand: bool):
    params = a1_params("cpu")
    model = fb.build_model(params)
    _, state = _fb_pair(_drop_fb() if stand else _rand_fb(6, height=0.27))
    cmd = _stand_arrays(B) if stand else _command_arrays(7)
    command = HybridCommand(**{k: torch.as_tensor(v) for k, v in cmd.items()})
    sim = wb.WholeBodySimState(fb=state, t=torch.zeros(B))
    for _ in range(steps):
        sim, flags = wb.whole_body_step(params, model, sim, command,
                                        wb.ContactModel(), DT)
    return {k: getattr(sim.fb, k).numpy() for k in FB_FIELDS}, flags.numpy()


def test_contact_forces_match_jax():
    """Penalty forces, flags and foot points of random states whose feet
    straddle the ground (base 0.27 m +/- 0.1 m, joints at random)."""
    from quadruped_tpu.sim import whole_body as jwb

    _, jmodel = _jax()
    tmodel = fb.build_model(a1_params("cpu"))
    jstate, tstate = _fb_pair(_rand_fb(6, height=0.27))
    want = jax.jit(jax.vmap(lambda s: jwb.contact_forces(
        jmodel, s, jwb.ContactModel())))(jstate)
    got = wb.contact_forces(tmodel, tstate, wb.ContactModel())
    flags = got[1].numpy()
    np.testing.assert_array_equal(flags, np.asarray(want[1]))
    assert 0 < flags.sum() < flags.size       # both cases present
    assert _max_err(got[0], want[0]) <= TOL["contact_forces"]
    assert _max_err(got[2], want[2]) <= TOL["foot_positions_world"]


def test_whole_body_step_matches_jax():
    """One step (2 substeps) under random hybrid commands."""
    want, want_flags = _jax_steps(1, stand=False)
    got, got_flags = _port_steps(1, stand=False)
    np.testing.assert_array_equal(got_flags, want_flags)
    for k in FB_FIELDS:
        assert _max_err(got[k], want[k]) <= STEP_TOL[k], k


def test_whole_body_50_ticks_match_jax():
    """50 ticks under the stand command: the drop, touchdown and first
    rebound."""
    want, _ = _jax_steps(50, stand=True)
    got, _ = _port_steps(50, stand=True)
    for k in FB_FIELDS:
        assert np.all(np.isfinite(got[k])), k
        assert _max_err(got[k], want[k]) <= STAND_TOL[k], k


def test_observe_matches_jax():
    from quadruped_tpu.sim import whole_body as jwb

    params, jmodel = _jax()
    tparams = a1_params("cpu")
    jstate, tstate = _fb_pair(_rand_fb(8, height=0.27))
    want = jax.jit(jax.vmap(lambda s: jwb.observe(
        params, jmodel, jwb.WholeBodySimState(fb=s, t=jnp.zeros(())),
        jwb.ContactModel())))(jstate)
    got = wb.observe(tparams, fb.build_model(tparams),
                     wb.WholeBodySimState(fb=tstate, t=torch.zeros(B)),
                     wb.ContactModel())
    for f in dataclasses.fields(got):
        tol = TOL["contact_forces"] if f.name == "foot_forces" else 1e-6
        assert _max_err(getattr(got, f.name),
                        getattr(want, f.name)) <= tol, f.name


# ---------------------------------------------------------- closed loop

def _loop_config_kw():
    return dict(horizon=5, qp_iters=24, qp_cold_iters=120)


@functools.lru_cache(maxsize=None)
def _jax_loop_fn():
    """jit(vmap) of the JAX whole-body closed loop from (vx, dh): the
    robots start dh above their stand height."""
    from quadruped_tpu.control import mpc as jm
    from quadruped_tpu.control import swing as js
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import (LocomotionConfig as JLC,
                                                  locomotion_init,
                                                  locomotion_step)
    from quadruped_tpu.gait import ADVANCED_TROT as JAT
    from quadruped_tpu.sim import whole_body as jwb

    params, model = _jax()
    contact = jwb.ContactModel()
    cfg = JLC(mpc=jm.MpcConfig(**_loop_config_kw()), swing=js.SwingConfig(),
              gait=JAT())

    def one(vx, dh):
        sim = jwb.whole_body_init(params, body_height=params.body_height + dh)
        ctrl = locomotion_init(cfg, params,
                               jwb.observe(params, model, sim, contact))
        cmd = JTC.constant(vx=vx, body_height=0.27)

        def step(carry, i):
            s, c = carry
            obs = jwb.observe(params, model, s, contact)
            command, _, c = locomotion_step(cfg, params, c, obs, cmd,
                                            (i + 1).astype(jnp.float32) * DT)
            s, _ = jwb.whole_body_step(params, model, s, command, contact, DT)
            return (s, c), (s.fb.position[2], jwb.observe(
                params, model, s, contact).base_vel_world[0])

        (s, _), (h, v) = jax.lax.scan(step, (sim, ctrl),
                                      jnp.arange(LOOP_TICKS))
        return s.fb, h, v

    return jax.jit(jax.vmap(one, in_axes=(0, None)))


@functools.lru_cache(maxsize=None)
def _jax_loop(dh: float = 0.0):
    s, h, v = _jax_loop_fn()(jnp.asarray(LOOP_VX, jnp.float32),
                             jnp.float32(dh))
    out = {k: np.asarray(getattr(s, k)) for k in FB_FIELDS}
    out["height_trace"] = np.asarray(h)
    out["vx_trace"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _port_loop():
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(**_loop_config_kw()),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT("cpu"))
    loop = twb.build(len(LOOP_VX), "cpu", config, LOOP_VX)
    loop, (h, v) = twb.run(loop, LOOP_TICKS)
    out = {k: getattr(loop.sim.fb, k).numpy() for k in FB_FIELDS}
    out["height_trace"] = h.numpy()
    out["vx_trace"] = v.numpy()
    return out


def _assert_loop_close(got, want):
    for key, tol in CLOSED_TOL.items():
        assert np.all(np.isfinite(got[key])), key
        assert _max_err(got[key], want[key]) <= tol, key


def test_closed_loop_matches_jax():
    got = _port_loop()
    _assert_loop_close(got, _jax_loop())
    assert np.all(got["height_trace"] > 0.2)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_closed_loop_fixture(side):
    """JAX still reproduces the fixture, and the port matches it."""
    data = dict(np.load(FIXTURE))
    np.testing.assert_array_equal(data["vx"], np.asarray(LOOP_VX, np.float32))
    assert int(data["ticks"]) == LOOP_TICKS
    _assert_loop_close(_jax_loop() if side == "jax" else _port_loop(), data)


# One float32 step of a start height in [0.25, 0.5) m.
ULP_HEIGHT = 3e-8


@pytest.mark.parametrize("case", ["stand_50_ticks", "closed_loop"])
def test_port_differs_from_jax_as_jax_from_itself(case):
    """The contact amplifies rounding: raising JAX's start heights by one
    float32 step moves its own result by as much as the port differs from
    it. Held: port vs JAX within 10x JAX vs its moved self, field by
    field. Measured (port vs JAX / JAX vs moved JAX): 50 stand ticks, quat
    1.5e-5 / 3.1e-5, position 2.3e-6 / 4.5e-6, omega 3.1e-3 / 1.6e-3, vel
    1.4e-4 / 1.4e-4, q 7.2e-5 / 6.3e-5, dq 4.5e-2 / 2.1e-2; the closed
    loop's traces, height 1.4e-4 / 6.1e-5 m, vx 5.2e-3 / 1.4e-3 m/s."""
    if case == "closed_loop":
        want, moved, got = _jax_loop(), _jax_loop(ULP_HEIGHT), _port_loop()
        keys = ("height_trace", "vx_trace")
    else:
        want, moved, got = (_jax_steps(50, True)[0],
                            _jax_steps(50, True, ULP_HEIGHT)[0],
                            _port_steps(50, True)[0])
        keys = FB_FIELDS
    for k in keys:
        own = _max_err(moved[k], want[k])
        assert 0 < own and _max_err(got[k], want[k]) <= 10 * own, k


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    FIXTURE.parent.mkdir(exist_ok=True)
    arrays = dict(_jax_loop(), vx=np.asarray(LOOP_VX, np.float32),
                  ticks=np.int32(LOOP_TICKS))
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
