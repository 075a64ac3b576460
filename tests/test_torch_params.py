"""The port's robot parameters and the JAX -> torch state converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import mpc as jm, swing as js
from quadruped_tpu.control.locomotion import (LocomotionConfig as JLC,
                                              locomotion_init as j_init)
from quadruped_tpu.gait import ADVANCED_TROT as JAT
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.sim import srb_sim as j_sim
from quadruped_tpu_torch.control.locomotion import LocomotionState
from quadruped_tpu_torch.robots.params import RobotParams, a1_params
from quadruped_tpu_torch.utils.convert import as_numpy, to_torch


def test_a1_params_equal_jax():
    """Every field, exactly (both are float32 casts of the same numbers)."""
    port, ref = a1_params("cpu"), j_a1()
    for f in dataclasses.fields(RobotParams):
        got = getattr(port, f.name)
        assert got.dtype == torch.float32, f.name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(port.signed_hip_length.numpy(),
                                  np.asarray(ref.signed_hip_length))
    np.testing.assert_array_equal(port.max_force.numpy(),
                                  np.asarray(ref.max_force))
    converted = to_torch(ref, RobotParams)
    for f in dataclasses.fields(RobotParams):
        assert torch.equal(getattr(converted, f.name), getattr(port, f.name))


@pytest.mark.parametrize("name", ["go1", "aliengo", "lite3", "lite2"])
def test_named_params_equal_jax(name):
    """The other robots, field by field and exactly, through named_params
    and through each robot's own factory."""
    from quadruped_tpu.robots import named_params as j_named
    from quadruped_tpu_torch.robots import params as t_params

    ref = j_named(name)
    for port in (t_params.named_params(name, "cpu"),
                 getattr(t_params, f"{name}_params")("cpu")):
        for f in dataclasses.fields(RobotParams):
            got = getattr(port, f.name)
            assert got.dtype == torch.float32, f.name
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(ref, f.name)),
                                          err_msg=f"{name}.{f.name}")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_converter_round_trips_vmapped_locomotion_state():
    """A jax.vmap-ed LocomotionState (3 scenarios, including the
    cold-start MpcState) converts to the port's dataclasses with the batch
    as leading axis, float32/int32 leaves, and exactly the same values."""
    cfg = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=40),
              swing=js.SwingConfig(), gait=JAT())
    params = j_a1()

    def init(h):
        sim0 = j_sim.srb_sim_init(params, body_height=h)
        obs0 = j_sim.observe(params, sim0, jnp.ones(4, jnp.float32))
        return j_init(cfg, params, obs0)

    state = jax.jit(jax.vmap(init))(jnp.asarray([0.26, 0.27, 0.28]))
    port = to_torch(state, LocomotionState)
    assert port.mpc.warm_dual.shape == (3, 20, 5)
    assert port.gait.leg_state.dtype == torch.int32
    assert port.mpc.forces_world.dtype == torch.float32
    want = _flatten(as_numpy(state))
    got = _flatten(as_numpy(port))
    assert want.keys() == got.keys()
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    # Broadcasting one scenario to a batch.
    single = to_torch(jax.tree.map(lambda a: a[0], state), LocomotionState,
                      batch=5)
    assert single.swing.foot_target_world.shape == (5, 4, 3)
    assert torch.equal(single.mpc.warm_primal[4], port.mpc.warm_primal[0])


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the entry points build on the card: the default
    is cuda where a card is found, and where none is they raise instead of
    building on the CPU."""
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT, named_gait
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.solvers.problems import bench_problems
    from quadruped_tpu_torch.utils import card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert card.default_device() == torch.device("cuda")
    assert card.resolve() == torch.device("cuda")
    assert card.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    constructors = [a1_params, ADVANCED_TROT, TROT,
                lambda: named_gait("walk"), lambda: named_params("go1"),
                lambda: TwistCommand.constant(vx=0.3),
                lambda: bench_problems(2, horizon=2),
                lambda: bench.build_bench(2, "loop", 10),
                lambda: bench.measure(2),
                lambda: mxu_rate.problems(2, torch.float32),
                lambda: mxu_rate.measure(2, 1)]
    for build in constructors:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert a1_params("cpu").total_mass.device.type == "cpu"
