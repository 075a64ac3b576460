"""The port's rollout traces (quadruped_tpu_torch/utils/trace.py) against
the JAX package's utils/trace.py (CPU).

The two JAX tests of tests/test_trace.py on the port (round trip with
meta, drift detected), and across the packages on the same inputs: a
trace either package saves loads in the other into a tree of the same
fields (dict keys sorted, dataclass fields in order), and
`compare_traces` gives JAX's numbers; a port rollout's result round-trips
through its NamedTuple and dataclasses.
"""

import numpy as np
import torch

from quadruped_tpu_torch.utils.trace import (compare_traces, load_trace,
                                             save_trace)

torch.set_num_threads(1)


def _tree():
    return {"b": {"c": torch.ones(3, 4)}, "a": torch.arange(10.0)}


def test_roundtrip(tmp_path):
    tree = _tree()
    p = save_trace(str(tmp_path / "t.npz"), tree, meta={"steps": 10})
    loaded, meta = load_trace(p, like=tree)
    assert meta["steps"] == 10
    np.testing.assert_allclose(loaded["a"], tree["a"].numpy())
    np.testing.assert_allclose(loaded["b"]["c"], tree["b"]["c"].numpy())
    diff = compare_traces(tree, loaded)
    assert diff["within_tol"]
    leaves, meta = load_trace(p)
    assert len(leaves) == 2 and leaves[0].shape == (10,)


def test_compare_detects_drift():
    tree = {"a": torch.arange(5.0)}
    other = {"a": torch.arange(5.0) + 0.1}
    diff = compare_traces(tree, other, atol=1e-3)
    assert not diff["within_tol"]
    np.testing.assert_allclose(diff["max"], 0.1, atol=1e-6)


def test_traces_cross_the_packages(tmp_path):
    import jax.numpy as jnp

    from quadruped_tpu.utils import trace as jtrace

    rng = np.random.default_rng(0)
    arrays = {"z": rng.standard_normal((4, 3)).astype(np.float32),
              "a": {"y": rng.standard_normal(7).astype(np.float32),
                    "b": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    port_tree = {"z": torch.from_numpy(arrays["z"]),
                 "a": {k: torch.from_numpy(v)
                       for k, v in arrays["a"].items()}}
    jax_tree = {"z": jnp.asarray(arrays["z"]),
                "a": {k: jnp.asarray(v) for k, v in arrays["a"].items()}}
    p_port = save_trace(str(tmp_path / "port.npz"), port_tree,
                        meta={"who": "port"})
    p_jax = jtrace.save_trace(str(tmp_path / "jax.npz"), jax_tree,
                              meta={"who": "jax"})
    got, meta = jtrace.load_trace(p_port, like=jax_tree)
    assert meta == {"who": "port"}
    np.testing.assert_array_equal(got["a"]["b"], arrays["a"]["b"])
    np.testing.assert_array_equal(got["z"], arrays["z"])
    got, meta = load_trace(p_jax, like=port_tree)
    assert meta == {"who": "jax"}
    np.testing.assert_array_equal(got["a"]["y"], arrays["a"]["y"])
    assert [x.shape for x in load_trace(p_jax)[0]] == \
        [x.shape for x in jtrace.load_trace(p_port)[0]]
    drifted = {"z": port_tree["z"] + 0.25, "a": port_tree["a"]}
    want = jtrace.compare_traces(
        jax_tree, {"z": jax_tree["z"] + 0.25, "a": jax_tree["a"]}, atol=0.1)
    assert compare_traces(port_tree, drifted, atol=0.1) == want


def test_rollout_result_roundtrip(tmp_path):
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import stack_params
    from quadruped_tpu_torch.sim.rollout import rollout

    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=12),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT("cpu"))
    res = rollout(config, stack_params(("go1", "aliengo"), "cpu"),
                  TwistCommand.constant(vx=0.2, batch=2, device="cpu"), 6)
    p = save_trace(str(tmp_path / "r.npz"), res, meta={"ticks": 6})
    back, meta = load_trace(p, like=res)
    assert meta == {"ticks": 6} and type(back) is type(res)
    np.testing.assert_array_equal(back.sim.q, res.sim.q.numpy())
    np.testing.assert_array_equal(back.control.gait.leg_state,
                                  res.control.gait.leg_state.numpy())
    assert back.control.transition is None
    assert compare_traces(res, back, atol=0.0)["within_tol"]
