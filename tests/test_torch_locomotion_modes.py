"""The force-balance locomotion modes (VELOCITY and POSITION) of the port's
closed loop against the JAX package.

* `rollout` in each mode on CPU, port vs JAX, 4 scenarios of the A1 with
  `TROT()` and `ForceBalanceConfig()` (64 whitened-ADMM iterations, 24
  polish passes): 200 ticks in VELOCITY, 150 in POSITION.
* The checked-in fixture tests/data/rollout_modes_a1.npz, the JAX package's
  output of the same runs: JAX must still reproduce it, and the port must
  match it, on the CPU and (marker `cuda`, where no JAX is installed) on
  the card.
* The twins of the JAX stability checks (tests/test_locomotion_modes.py) on
  the port's runs. (The WALK mode and gait transitions are held in
  tests/test_torch_gait_transition.py.)

Tolerances as tests/test_torch_rollout.py: height 2e-4 m, velocity
5e-3 m/s, joints 2e-3 rad, forces 1% m*g; touchdown anchors 1e-3 m (the
velocity-mode foothold moves with the base velocity times half the stance
time, 0.15 s, so the velocity bound allows 7.5e-4 m; measured 2e-4 m).
Forces are compared on the ticks where neither package's force-balance
solve missed its minimizer: on a few ticks in a thousand the active-set
polish meets a singular Gram matrix and returns forces outside a leg's
friction pyramid (test_torch_force_balance.py says why); which ticks
differs between the packages (here 5 of the port's 1,400 ticks and 2 of
JAX's, tests/force_balance_sweep.py). Such a tick moves the body by less
than the tolerances above (the sim applies stance-leg forces only, and the
next tick solves anew).

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_locomotion_modes.py
"""

import functools
from pathlib import Path

import numpy as np
import pytest

from card_device import on
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import ControlMode, TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.control.stance_force_balance import \
    ForceBalanceConfig
from quadruped_tpu_torch.gait import TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim.rollout import rollout

FIXTURE = Path(__file__).parent / "data" / "rollout_modes_a1.npz"
# Per mode: the commanded forward speeds of the 4 scenarios and the ticks.
MODES = {"velocity": (ControlMode.VELOCITY, [0.1, 0.2, 0.25, 0.4], 200),
         "position": (ControlMode.POSITION, [0.0, 0.03, 0.06, 0.1], 150)}
SIM_FIELDS = ("position", "quat", "vel_world", "omega_world", "q", "dq",
              "foot_anchor")
# The fixture keeps every 5th tick of the traces.
TRACE_STRIDE = 5
MG = 13.0 * 9.81
MU = 0.45
TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
       "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
       "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-3}


def _port_config(mode, device="cpu"):
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                            swing=swing_mod.SwingConfig(mode=mode),
                            gait=TROT(device), mode=mode,
                            force_balance=ForceBalanceConfig())


def _jax_config(mode):
    from quadruped_tpu.control import mpc as jm
    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control import swing as js
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.gait import TROT as JTROT

    return JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=30),
               swing=js.SwingConfig(mode=mode), gait=JTROT(), mode=mode,
               force_balance=jfb.ForceBalanceConfig())


def _summary(res, to_numpy):
    out = {f: to_numpy(getattr(res.sim, f)) for f in SIM_FIELDS}
    out["base_height_trace"] = to_numpy(res.base_height_trace)
    out["vel_trace"] = to_numpy(res.vel_trace)
    out["forces_trace"] = to_numpy(res.forces_trace)
    out["alive"] = to_numpy(res.alive)
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim.rollout import rollout as jro

    mode, vx, steps = MODES[name]
    cfg = _jax_config(mode)
    res = jax.jit(jax.vmap(lambda v: jro(cfg, ja1(), JTC.constant(
        vx=v, body_height=0.27), steps=steps)))(jnp.asarray(vx, jnp.float32))
    return _summary(res, np.asarray)


@functools.lru_cache(maxsize=None)
def _port_run(name, device="cpu"):
    mode, vx, steps = MODES[name]
    res = rollout(_port_config(mode, device), a1_params(device),
                  TwistCommand.constant(vx=np.asarray(vx, np.float32),
                                        body_height=0.27, device=device),
                  steps=steps)
    return _summary(res, lambda t: t.cpu().numpy())


def _fixture_view(run):
    """The part of a run the fixture keeps."""
    out = {f: run[f] for f in SIM_FIELDS}
    out["alive"] = run["alive"]
    for key in ("base_height_trace", "vel_trace"):
        out[key] = run[key][:, TRACE_STRIDE - 1::TRACE_STRIDE]
    return out


def _missed(forces):
    """[..., 4, 3] -> [...]: a tick whose forces leave a leg's friction
    pyramid or pull on the ground (a polish miss), with 0.5 N of slack."""
    fz = forces[..., 2]
    ft = np.max(np.abs(forces[..., :2]), axis=-1)
    return np.any((fz < -0.5) | (ft > MU * np.maximum(fz, 0.0) + 0.5),
                  axis=-1)


def _assert_close(got, want, keys=TOL):
    np.testing.assert_array_equal(got["alive"], want["alive"])
    for key in keys:
        assert np.all(np.isfinite(got[key])), key
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= TOL[key], f"{key}: max |diff| {err} > {TOL[key]}"


@pytest.mark.parametrize("name", list(MODES))
def test_rollout_matches_jax(name):
    got, want = _port_run(name), _jax_run(name)
    _assert_close(got, want)
    missed_port = _missed(got["forces_trace"])
    missed_jax = _missed(want["forces_trace"])
    ticks = missed_port.size
    assert missed_port.sum() <= 0.01 * ticks, missed_port.sum()
    assert missed_jax.sum() <= 0.01 * ticks, missed_jax.sum()
    held = ~(missed_port | missed_jax)
    err = np.abs(got["forces_trace"] - want["forces_trace"]).max((-1, -2))
    assert err[held].max() <= 0.01 * MG, err[held].max()


@pytest.mark.parametrize(
    "side", ["jax", "port", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("name", list(MODES))
def test_fixture(name, side):
    """JAX still reproduces the fixture, and the port matches it on the
    CPU and on the card."""
    data = np.load(FIXTURE)
    want = {k[len(name) + 1:]: data[k] for k in data.files
            if k.startswith(name + "_")}
    np.testing.assert_array_equal(want["vx"], np.asarray(MODES[name][1],
                                                         np.float32))
    assert int(want["ticks"]) == MODES[name][2]
    assert int(data["trace_stride"]) == TRACE_STRIDE
    run = (_jax_run(name) if side == "jax" else _port_run(name)
           if side == "port" else _port_run(name, on(side)))
    _assert_close(_fixture_view(run), want,
                  keys=[k for k in TOL if k in want])


def test_velocity_mode_trot_stable():
    """The twin of the JAX check: alive, height in its band, moving forward
    under the command (scenario vx = 0.25)."""
    run = _port_run("velocity")
    i = MODES["velocity"][1].index(0.25)
    assert run["alive"][i] == 1.0
    h = run["base_height_trace"][i]
    assert np.all(np.isfinite(h))
    assert 0.2 < h[-1] < 0.35
    assert run["vel_trace"][i, -50:, 0].mean() > 0.05


def test_position_mode_runs():
    run = _port_run("position")
    assert np.all(run["alive"] == 1.0)
    assert np.all(np.isfinite(run["base_height_trace"]))


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    FIXTURE.parent.mkdir(exist_ok=True)
    arrays = {"trace_stride": np.int32(TRACE_STRIDE)}
    for name, (_, vx, steps) in MODES.items():
        arrays[f"{name}_vx"] = np.asarray(vx, np.float32)
        arrays[f"{name}_ticks"] = np.int32(steps)
        for key, value in _fixture_view(_jax_run(name)).items():
            arrays[f"{name}_{key}"] = value
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
