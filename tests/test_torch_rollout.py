"""The port's closed loop as a whole against the JAX package.

* `rollout_cadenced` (the scenario-sweep workhorse) and `rollout` (cadence
  multiplexing inside the tick) on CPU, port vs JAX, 4 scenarios.
* The checked-in fixture tests/data/rollout_cadenced_a1_h10.npz: the JAX
  package's `rollout_cadenced` at the production MPC configuration. JAX must
  still reproduce it, and the port must match it, on the CPU and (marker
  `cuda`, where no JAX is installed) on the card.
* A port-only stability gate, as tests/test_rollout_cadenced.py.

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_rollout.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from card_device import on
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim.rollout import rollout
from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

FIXTURE = Path(__file__).parent / "data" / "rollout_cadenced_a1_h10.npz"
VX = np.array([0.0, 0.2, 0.4, 0.6], np.float32)
N_PERIODS = 4
SIM_FIELDS = ("position", "quat", "vel_world", "omega_world", "q", "dq",
              "foot_anchor")
MG = 13.0 * 9.81

# Port vs JAX tolerances, per quantity. Both run the same float32
# arithmetic; they differ in summation order and in the bf16 rounding of
# the Newton-Schulz steps, which the production single f32 polish step
# leaves at ~1e-4 relative in M^{-1} and the warm ADMM budget carries into
# the forces (measured on CPU: <= 1.0 N at H=10, 0.17 N at H=5; the golden
# gate is 3% m*g = 3.8 N). Positions follow at ~1e-5 m over these short
# windows; the bounds below are about 10x what was measured on CPU.
TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
       "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
       "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-5}


def _jax_config(horizon, qp_iters):
    from quadruped_tpu.control import mpc as jm, swing as js
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.gait import ADVANCED_TROT as JAT

    kw = {} if qp_iters is None else {"qp_iters": qp_iters}
    return JLC(mpc=jm.MpcConfig(horizon=horizon, **kw),
               swing=js.SwingConfig(), gait=JAT())


def _port_config(horizon, qp_iters, device="cpu"):
    kw = {} if qp_iters is None else {"qp_iters": qp_iters}
    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=horizon, **kw),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT(device))


def _jax_cadenced(horizon, qp_iters):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim.rollout_cadenced import rollout_cadenced as jrc

    cfg = _jax_config(horizon, qp_iters)
    res = jax.jit(jax.vmap(lambda v: jrc(cfg, ja1(), JTC.constant(vx=v),
                                         n_periods=N_PERIODS)))(
        jnp.asarray(VX))
    out = {f: np.asarray(getattr(res.sim, f)) for f in SIM_FIELDS}
    out["base_height_trace"] = np.asarray(res.base_height_trace)
    out["vel_trace"] = np.asarray(res.vel_trace)
    out["alive"] = np.asarray(res.alive)
    return out


def _port_cadenced(horizon, qp_iters, device="cpu"):
    res = rollout_cadenced(_port_config(horizon, qp_iters, device),
                           a1_params(device),
                           TwistCommand.constant(vx=VX, device=device),
                           N_PERIODS)
    out = {f: getattr(res.sim, f).cpu().numpy() for f in SIM_FIELDS}
    out["base_height_trace"] = res.base_height_trace.cpu().numpy()
    out["vel_trace"] = res.vel_trace.cpu().numpy()
    out["alive"] = res.alive.cpu().numpy()
    return out


def _assert_close(got, want):
    assert np.array_equal(got["alive"], want["alive"])
    for key, tol in TOL.items():
        assert np.all(np.isfinite(got[key])), key
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= tol, f"{key}: max |diff| {err} > {tol}"


def test_cadenced_matches_jax_h5():
    """H=5 with 40 warm Fast-ADMM iterations (the config of
    tests/test_rollout_cadenced.py), 4 scenarios over 4 periods."""
    _assert_close(_port_cadenced(5, 40), _jax_cadenced(5, 40))


def test_rollout_matches_jax():
    """`rollout` (MPC cadence inside the tick) over 24 ticks at H=5.
    Forces within 1% m*g (measured 0.17 N on CPU)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim.rollout import rollout as jro

    cfg = _jax_config(5, 40)
    jr = jax.jit(jax.vmap(lambda v: jro(cfg, ja1(), JTC.constant(vx=v),
                                        steps=24)))(jnp.asarray(VX))
    r = rollout(_port_config(5, 40), a1_params("cpu"),
                TwistCommand.constant(vx=VX, device="cpu"),
                steps=24)
    np.testing.assert_array_equal(r.alive.numpy(), np.asarray(jr.alive))
    np.testing.assert_allclose(r.base_height_trace.numpy(),
                               np.asarray(jr.base_height_trace), atol=2e-4)
    np.testing.assert_allclose(r.vel_trace.numpy(), np.asarray(jr.vel_trace),
                               atol=5e-3)
    np.testing.assert_allclose(r.forces_trace.numpy(),
                               np.asarray(jr.forces_trace), atol=0.01 * MG)
    np.testing.assert_allclose(r.sim.q.numpy(), np.asarray(jr.sim.q),
                               atol=2e-3)


@pytest.mark.parametrize(
    "side", ["jax", "port", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fixture(side):
    """The production-config fixture (H=10, 24 warm Fast-ADMM iterations,
    400-iteration boot): JAX still reproduces it, the port matches it on
    the CPU and on the card."""
    want = dict(np.load(FIXTURE))
    np.testing.assert_array_equal(want["vx"], VX)
    got = (_jax_cadenced(10, None) if side == "jax"
           else _port_cadenced(10, None, on("cpu" if side == "port"
                                            else side)))
    _assert_close(got, want)


def test_port_stable_trot():
    """Port-only stability gate (tests/test_rollout_cadenced.py's): 40
    periods at H=5, vx=0.3."""
    res = rollout_cadenced(_port_config(5, 40), a1_params("cpu"),
                           TwistCommand.constant(vx=0.3, body_height=0.27,
                                                 device="cpu"),
                           n_periods=40)
    assert float(res.alive[0]) == 1.0
    h = res.base_height_trace[0].numpy()
    assert np.all(np.isfinite(h))
    assert 0.2 < h[-1] < 0.35
    assert res.vel_trace[0, -10:, 0].mean().item() > 0.1


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, vx=VX, **_jax_cadenced(10, None))
    print("wrote", FIXTURE)
