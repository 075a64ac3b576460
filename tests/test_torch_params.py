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


def _assert_same_values(port, ref):
    want = _flatten(as_numpy(ref))
    got = _flatten(as_numpy(port))
    assert want.keys() == got.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype in (np.float32, np.int32, np.bool_), key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("name", ["FloatingBaseModel", "FbState",
                                  "WholeBodySimState", "ContactModel",
                                  "WbcConfig", "WbcCommand"])
def test_converter_carries_whole_body_dataclasses(name):
    """Each whole-body dataclass of the JAX package, batched by jax.vmap
    (3 scenarios) where it is per robot, carried across by `to_torch` with
    exactly the same values: the model and the configurations as they
    are, the states with the batch as leading axis."""
    from quadruped_tpu.control import wbc as jwbc
    from quadruped_tpu.dynamics import floating_base as jfb
    from quadruped_tpu.sim import whole_body as jwb
    from quadruped_tpu_torch.control import wbc as twbc
    from quadruped_tpu_torch.dynamics import floating_base as tfb
    from quadruped_tpu_torch.sim import whole_body as twb

    params = j_a1()
    heights = jnp.asarray([0.26, 0.27, 0.28])
    sims = jax.vmap(lambda h: jwb.whole_body_init(params, body_height=h))(
        heights)

    def command(h):
        z = jnp.zeros(3)
        feet = jnp.tile(jnp.asarray([0.1, 0.1, 0.0]) * h, (4, 1))
        return jwbc.WbcCommand(
            p_body_des=z.at[2].set(h), v_body_des=z, a_body_des=z,
            rpy_des=z, omega_des_world=z, p_foot_des=feet,
            v_foot_des=feet * 0, a_foot_des=feet * 0,
            fr_des=feet + 30.0, contact_state=jnp.asarray([1.0, 0, 0, 1]))

    ref, cls = {
        "FloatingBaseModel": (jfb.build_model(params), tfb.FloatingBaseModel),
        "FbState": (sims.fb, tfb.FbState),
        "WholeBodySimState": (sims, twb.WholeBodySimState),
        "ContactModel": (jwb.ContactModel(), twb.ContactModel),
        "WbcConfig": (jwbc.WbcConfig(), twbc.WbcConfig),
        "WbcCommand": (jax.vmap(command)(heights), twbc.WbcCommand),
    }[name]
    port = to_torch(ref, cls)
    _assert_same_values(port, ref)
    if name in ("FbState", "WholeBodySimState", "WbcCommand"):
        leaf = port.fb.q if name == "WholeBodySimState" else (
            port.q if name == "FbState" else port.p_foot_des)
        assert leaf.shape[0] == 3
    if name == "WbcConfig":
        assert port.qp_iters == 50 and port.friction_mu == 0.4


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the entry points build on the card: the default
    is cuda where a card is found, and where none is they raise instead of
    building on the CPU."""
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.dynamics.floating_base import build_model
    from quadruped_tpu_torch.entry import entry
    from quadruped_tpu_torch.sim.whole_body import whole_body_init
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
                lambda: mxu_rate.measure(2, 1),
                entry, lambda: build_model(a1_params()),
                lambda: whole_body_init(a1_params(), 2),
                lambda: bench_wbc.build(2), lambda: bench_wb.build(2)]
    for build in constructors:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert a1_params("cpu").total_mass.device.type == "cpu"
