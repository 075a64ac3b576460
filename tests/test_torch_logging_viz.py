"""The port's utils/logging.py, utils/viz.py and utils/viz3d.py against the
JAX package's (CPU).

* `summarize_rollout` of a 4-scenario rollout: the port's function on a
  `RolloutResult` carrying JAX's traces (batch-first) equals the JAX
  function on the same traces (time-first, as the JAX function reads
  them) within 1e-6; the port's own rollout of the same scenarios
  summarizes within tests/test_torch_rollout.py's limits.
* `MetricsLogger` writes the JAX records, `t` aside.
* `plot_rollout` and `plot_gait_diagram` draw the JAX figures, pixel for
  pixel, from the same traces.
* `skeleton_points` against JAX's for the A1 and the Lite3 on random rpy
  and joint angles within 1e-5 m; the skeleton's link lengths on a
  whole-body stand trace; `snapshot` and `animate_rollout` write a PNG and
  a GIF (the twin of tests/test_viz3d.py).
* `profile_trace` writes a Chrome trace of one call on the CPU, with the
  port's spans in it.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.robots import named_params
from quadruped_tpu_torch.sim.rollout import RolloutResult
from quadruped_tpu_torch.utils import logging as tlog
from quadruped_tpu_torch.utils import viz as tviz
from quadruped_tpu_torch.utils import viz3d as tviz3d

torch.set_num_threads(1)

VX = np.array([0.0, 0.2, 0.4, 0.6], np.float32)
TICKS = 24


def _jax_rollout():
    """JAX's 4-scenario rollout (H=5, 40 iterations, 24 ticks), traces
    [B, T, ...] as jax.vmap returns them."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as jm, swing as js
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.gait import ADVANCED_TROT as JAT
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim.rollout import rollout as jro

    cfg = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=40),
              swing=js.SwingConfig(), gait=JAT())
    return jax.jit(jax.vmap(lambda v: jro(cfg, ja1(), JTC.constant(vx=v),
                                          steps=TICKS)))(jnp.asarray(VX))


def _time_first(jr):
    """JAX's vmapped traces laid out time-first, as the JAX summarize and
    plot functions read a batched run."""
    return types.SimpleNamespace(
        alive=np.asarray(jr.alive),
        base_height_trace=np.asarray(jr.base_height_trace).T,
        vel_trace=np.moveaxis(np.asarray(jr.vel_trace), 1, 0),
        forces_trace=np.moveaxis(np.asarray(jr.forces_trace), 1, 0))


def _carried(jr) -> RolloutResult:
    t = lambda a: torch.from_numpy(np.array(a))
    return RolloutResult(sim=None, control=None, alive=t(jr.alive),
                         base_height_trace=t(jr.base_height_trace),
                         vel_trace=t(jr.vel_trace),
                         forces_trace=t(jr.forces_trace),
                         tau_trace=None)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_rollout()


def test_summarize_rollout_matches_jax(jax_run):
    from quadruped_tpu.utils import logging as jlog

    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout import rollout

    want = jlog.summarize_rollout(_time_first(jax_run))
    got = tlog.summarize_rollout(_carried(jax_run))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    cfg = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
                           swing=swing_mod.SwingConfig(),
                           gait=ADVANCED_TROT("cpu"))
    own = tlog.summarize_rollout(rollout(
        cfg, a1_params("cpu"), TwistCommand.constant(vx=VX, device="cpu"),
        steps=TICKS))
    assert own["alive_fraction"] == want["alive_fraction"] == 1.0
    assert abs(own["mean_height"] - want["mean_height"]) < 2e-4
    assert abs(own["final_speed"] - want["final_speed"]) < 5e-3


def test_metrics_logger_records_match_jax(tmp_path):
    from quadruped_tpu.utils import logging as jlog

    records = [dict(tick=3, height=np.float32(0.27), mode="trot"),
               dict(loss=torch.tensor(1.5), label=None)]
    files = {}
    for name, cls in (("jax", jlog.MetricsLogger),
                      ("port", tlog.MetricsLogger)):
        logger = cls(path=str(tmp_path / f"{name}.jsonl"))
        for rec in records:
            r = logger.log(**{k: (np.asarray(v) if name == "jax"
                                  and isinstance(v, torch.Tensor) else v)
                              for k, v in rec.items()})
            assert r["t"] >= 0.0
        files[name] = [json.loads(line) for line in
                       (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"}
                          for r in recs]
    assert strip(files["port"]) == strip(files["jax"])
    assert tlog.MetricsLogger().path == \
        "/tmp/quadruped_tpu_torch_metrics.jsonl"


def test_plots_match_jax(jax_run, tmp_path):
    import matplotlib.image as mpimg

    from quadruped_tpu.utils import viz as jviz

    for kw in ({}, {"batch_index": 2}):
        paths = [jviz.plot_rollout(_time_first(jax_run),
                                   str(tmp_path / "j.png"), **kw),
                 tviz.plot_rollout(_carried(jax_run),
                                   str(tmp_path / "p.png"), **kw)]
        a, b = (mpimg.imread(p) for p in paths)
        assert a.shape == b.shape and np.array_equal(a, b), kw
    legs = np.random.default_rng(0).integers(0, 4, (200, 4))
    paths = [jviz.plot_gait_diagram(legs, str(tmp_path / "jg.png")),
             tviz.plot_gait_diagram(torch.from_numpy(legs),
                                    str(tmp_path / "pg.png"))]
    a, b = (mpimg.imread(p) for p in paths)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("robot", ["a1", "lite3"])
def test_skeleton_points_match_jax(robot):
    from quadruped_tpu.robots import named_params as jnamed
    from quadruped_tpu.utils import viz3d as jviz3d

    rng = np.random.default_rng(7)
    jp, tp = jnamed(robot), named_params(robot, "cpu")
    for _ in range(4):
        pos = rng.normal(size=3).astype(np.float32) * 0.2 + [0, 0, 0.3]
        rpy = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
        q = (np.asarray(jp.stand_angles)
             + rng.uniform(-0.3, 0.3, 12)).astype(np.float32)
        want = jviz3d.skeleton_points(jp, pos, rpy, q)
        got = tviz3d.skeleton_points(tp, pos, rpy, torch.from_numpy(q))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - np.asarray(w)).max() <= 1e-5


def _stand_trace(steps=40):
    """A whole-body stand trace of the port (A1, kp 120, kd 3)."""
    from quadruped_tpu_torch.control.types import HybridCommand
    from quadruped_tpu_torch.core import se3
    from quadruped_tpu_torch.dynamics import floating_base as fb
    from quadruped_tpu_torch.sim import whole_body as wb

    params = named_params("a1", "cpu")
    model = fb.build_model(params)
    command = HybridCommand(q=params.stand_angles[None].clone(),
                            kp=torch.full((1, 12), 120.0),
                            dq=torch.zeros(1, 12),
                            kd=torch.full((1, 12), 3.0),
                            tau=torch.zeros(1, 12))
    s = wb.whole_body_init(params, 1)
    cm = wb.ContactModel()
    pos, rpy, q, contact = [], [], [], []
    for _ in range(steps):
        s, flags = wb.whole_body_step(params, model, s, command, cm, 0.002)
        pos.append(s.fb.position[0])
        rpy.append(se3.quat_to_rpy(s.fb.quat)[0])
        q.append(s.fb.q[0])
        contact.append(flags[0])
    return params, tviz3d.Viz3DTrace(
        position=torch.stack(pos).numpy(), rpy=torch.stack(rpy).numpy(),
        joint_angles=torch.stack(q).numpy(),
        contact=torch.stack(contact).numpy())


def test_skeleton_geometry():
    params, trace = _stand_trace(steps=2)
    trunk, legs = tviz3d.skeleton_points(params, trace.position[0],
                                         trace.rpy[0], trace.joint_angles[0])
    assert trunk.shape == (5, 3) and legs.shape == (4, 3, 3)
    upper, lower, hip_l = (float(params.upper_length),
                           float(params.lower_length),
                           float(params.hip_length))
    for i in range(4):
        hip, knee, foot = legs[i]
        assert abs(np.linalg.norm(knee - hip) - np.hypot(hip_l, upper)) \
            < 0.02
        assert abs(np.linalg.norm(foot - knee) - lower) < 0.01
        assert foot[2] < 0.08


def test_snapshot_and_gif(tmp_path):
    params, trace = _stand_trace(steps=40)
    png = tviz3d.snapshot(params, trace, str(tmp_path / "s.png"),
                          ticks=(0, 39),
                          terrain=lambda x, y: torch.zeros_like(x))
    assert os.path.getsize(png) > 10_000
    gif = tviz3d.animate_rollout(params, trace, str(tmp_path / "a.gif"),
                                 every=10, fps=5)
    assert os.path.getsize(gif) > 20_000


def test_profile_trace_writes_a_trace(tmp_path):
    from quadruped_tpu_torch.sim import srb_sim

    params = named_params("a1", "cpu")
    state = srb_sim.srb_sim_init(params, 2)
    x = torch.randn(64, 64)

    def call(a):
        srb_sim.observe(params, state, torch.ones(2, 4))
        return a @ a

    out = tlog.profile_trace(call, (x,), str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert out == str(tmp_path / "prof")
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    assert "qtpu.sim.observe" in names
