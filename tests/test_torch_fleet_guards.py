"""One robot and fleets of robots on the port's paths (CPU, no JAX).

* Every path that takes one robot gives the same bits with the one-robot
  parameters as it gave before stacked parameters existed: the ADVANCED_TROT
  `rollout` and `rollout_cadenced`, VELOCITY and POSITION, `use_wbc`, the
  whole-body loop, the walk, the trot -> walk -> trot transition loop, the
  robot runner on estimates, and the kinematics of all five robots.
  tests/data/unstacked_paths.npz holds what `_paths()` gave on the tree
  before stacked parameters (commit 36e5933), with the torch version and
  the CPU capability (`torch.backends.cpu.get_cpu_capability()`) of the
  host that made it, written by
      git archive 36e5933 | tar -x -C <dir>
      PYTHONPATH=<dir> python tests/test_torch_fleet_guards.py
  and the test asks for equal arrays, bit for bit. A mismatch names both
  hosts' torch and CPU capability. Where they differ, CPU kernels of
  another build or SIMD width may round the last bit otherwise with no
  change of code: regenerate the fixture on that host with the same two
  commands, from commit 36e5933, and the test holds the current tree to it
  there. Where they are the same, the one-robot arithmetic changed.
* The paths this slice leaves to one robot refuse stacked parameters
  with NotImplementedError at their entry points, before any arithmetic:
  VELOCITY, POSITION and WALK (the force-balance stance) and `use_wbc` at
  `locomotion_init`, the walk stack at `walk_init`, the whole-body model
  and sim at `build_model` and `whole_body_init`, and the robot runner at
  `runner_init`; and `rollout_init` refuses a fleet whose scenario axis
  is not the batch.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "unstacked_paths.npz"
ROBOTS = ("a1", "go1", "aliengo", "lite3", "lite2")


def _np(x):
    return x.detach().cpu().numpy()


def _paths() -> dict:
    """Short runs of every one-robot path at B=2 on the CPU; only modules
    that existed before stacked parameters."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner
    from quadruped_tpu_torch.benchmarks import transition as bench_trans
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control import wbc as wbc_mod
    from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                           TwistCommand)
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.control.stance_force_balance import \
        ForceBalanceConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
    from quadruped_tpu_torch.robots import kinematics, named_params
    from quadruped_tpu_torch.sim.rollout import rollout
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

    out = {}
    dev = "cpu"
    a1 = named_params("a1", dev)
    cmd = TwistCommand.constant(vx=np.array([0.1, 0.4], np.float32),
                                wz=np.array([0.0, 0.2], np.float32),
                                device=dev)

    def keep(prefix, res):
        for k in ("base_height_trace", "vel_trace", "forces_trace",
                  "tau_trace"):
            if hasattr(res, k):
                out[f"{prefix}/{k}"] = _np(getattr(res, k))
        for k in ("position", "quat", "q", "dq", "foot_anchor"):
            out[f"{prefix}/sim/{k}"] = _np(getattr(res.sim, k))

    trot = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT(dev))
    keep("trot", rollout(trot, a1, cmd, 24))
    keep("cadenced", rollout_cadenced(dataclasses.replace(
        trot, mpc=mpc_mod.MpcConfig()), a1, cmd, 2))
    for name, mode in (("velocity", ControlMode.VELOCITY),
                       ("position", ControlMode.POSITION)):
        cfg = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                               swing=swing_mod.SwingConfig(mode=mode),
                               gait=TROT(dev), mode=mode,
                               force_balance=ForceBalanceConfig())
        keep(name, rollout(cfg, a1, cmd, 4))
    keep("wbc", rollout(dataclasses.replace(trot, wbc=wbc_mod.WbcConfig(),
                                          use_wbc=True), a1, cmd, 10))
    keep("transition", rollout(bench_trans.config(dev), a1, cmd, 10))
    loop, (h, vx) = bench_wb.run(bench_wb.build(2, dev), 4)
    out["whole_body/height"], out["whole_body/vx"] = _np(h), _np(vx)
    out["whole_body/q"] = _np(loop.sim.fb.q)
    _, tr = bench_walk.run(bench_walk.build(2, dev), 3, record=True)
    out.update({f"walk/{k}": _np(v) for k, v in tr.items()})
    _, tr = bench_runner.run(bench_runner.build(2, dev), 3, record=True)
    out.update({f"runner/{k}": _np(v) for k, v in tr.items()})

    rng = np.random.default_rng(0)
    q = torch.as_tensor(
        np.tile([0.0, 0.7, -1.3], 4) + 0.2 * rng.standard_normal((3, 12)),
        dtype=torch.float32)
    dq = torch.as_tensor(rng.standard_normal((3, 12)), dtype=torch.float32)
    f = torch.as_tensor(rng.standard_normal((3, 4, 3)) * 20,
                        dtype=torch.float32)
    for name in ROBOTS:
        p = named_params(name, dev)
        feet = kinematics.foot_positions_in_base_frame(p, q)
        out[f"kin/{name}/feet"] = _np(feet)
        out[f"kin/{name}/ik"] = _np(
            kinematics.joint_angles_from_foot_positions(p, feet))
        out[f"kin/{name}/jac"] = _np(kinematics.all_leg_jacobians(p, q))
        out[f"kin/{name}/foot_vel"] = _np(
            kinematics.foot_velocities_in_base_frame(p, q, dq))
        out[f"kin/{name}/tau"] = _np(
            kinematics.map_contact_forces_to_torques(p, q, f))
    return out


def _host() -> dict:
    """What decides the CPU's last bits besides the code."""
    return {"torch": torch.__version__,
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def test_one_robot_paths_bit_identical():
    """Every one-robot path gives the fixture's bits."""
    want = np.load(FIXTURE)
    made = {k: str(want[f"meta/{k}"]) for k in _host()}
    hosts = (f"fixture made with {made}, this host {_host()}: "
             + ("the same host, so the arithmetic changed"
                if made == _host() else
                "another host; see the module docstring to regenerate"))
    got = _paths()
    assert sorted(got) == sorted(k for k in want.files
                                 if not k.startswith("meta/")), hosts
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"{k}; {hosts}")


def _fleet(n=2):
    from quadruped_tpu_torch.robots import stack_params

    return stack_params(ROBOTS[:n], "cpu")


def _obs(params, batch):
    from quadruped_tpu_torch.sim import srb_sim

    sim = srb_sim.srb_sim_init(params, batch)
    return srb_sim.observe(params, sim, torch.ones(batch, 4))


def _locomotion_config(**kw):
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT

    return LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT("cpu"), **kw)


@pytest.mark.parametrize("mode", ["velocity", "position", "walk"])
def test_force_balance_modes_refuse_a_fleet(mode):
    """VELOCITY, POSITION and WALK refuse a fleet where a caller starts
    them: `locomotion_init`, so `rollout` and `rollout_cadenced`, and the
    walk stack's own `walk_init`."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.control import walk_locomotion
    from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                           TwistCommand)
    from quadruped_tpu_torch.control.locomotion import locomotion_init
    from quadruped_tpu_torch.sim.rollout import rollout
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

    params = _fleet()
    obs = _obs(params, 2)
    m = {"velocity": ControlMode.VELOCITY, "position": ControlMode.POSITION,
         "walk": ControlMode.WALK}[mode]
    cfg = _locomotion_config(mode=m)
    cmd = TwistCommand.constant(vx=0.2, batch=2, device="cpu")
    for start in (lambda: locomotion_init(cfg, params, obs),
                  lambda: rollout(cfg, params, cmd, 2),
                  lambda: rollout_cadenced(cfg, params, cmd, 2)):
        with pytest.raises(NotImplementedError, match="force-balance"):
            start()
    if mode == "walk":
        with pytest.raises(NotImplementedError, match="WALK"):
            walk_locomotion.walk_init(bench_walk.walk_config(
                bench_walk.walk_table("cpu")), params, obs)


def test_wbc_whole_body_and_runner_refuse_a_fleet():
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import locomotion_init
    from quadruped_tpu_torch.dynamics import floating_base as fb
    from quadruped_tpu_torch.exec import RunnerConfig, runner_init
    from quadruped_tpu_torch.sim import rollout as rollout_mod
    from quadruped_tpu_torch.sim import whole_body

    params = _fleet()
    obs = _obs(params, 2)
    cmd = TwistCommand.constant(vx=0.2, batch=2, device="cpu")
    wbc_cfg = _locomotion_config(use_wbc=True)
    with pytest.raises(NotImplementedError, match="use_wbc"):
        locomotion_init(wbc_cfg, params, obs)
    with pytest.raises(NotImplementedError, match="use_wbc"):
        rollout_mod.rollout(wbc_cfg, params, cmd, 2)
    with pytest.raises(NotImplementedError, match="whole-body model"):
        fb.build_model(params)
    with pytest.raises(NotImplementedError, match="whole-body sim"):
        whole_body.whole_body_init(params, 2)
    with pytest.raises(NotImplementedError, match="robot runner"):
        runner_init(RunnerConfig(locomotion=_locomotion_config()), params,
                    obs)


@pytest.mark.parametrize("batch", [1, 3])
def test_rollout_init_refuses_a_fleet_of_another_size(batch):
    from quadruped_tpu_torch.sim import rollout as rollout_mod

    with pytest.raises(ValueError, match="stacked parameters of 2 robots"):
        rollout_mod.rollout_init(_locomotion_config(), _fleet(), batch)


def test_stack_refuses_stacked_parameters():
    from quadruped_tpu_torch.robots import stack

    with pytest.raises(ValueError, match="one-robot"):
        stack([_fleet(), _fleet()])


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **_paths(), **{
        f"meta/{k}": np.asarray(v) for k, v in _host().items()})
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
