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
      sed -i 's/fused_admm(inp.m_inv, /fused_admm(inp.m_inv.transpose(1, 2), /' \
          <dir>/quadruped_tpu_torch/solvers/cone_qp.py
      PYTHONPATH=<dir> python tests/test_torch_fleet_guards.py
  (the sed gives that tree the one later change of the one-robot
  arithmetic: K1's mat-vec becomes the JAX `solve`'s M^{-1} rhs, which
  `fused_admm` now computes from M^{-1} as given), and the test asks for
  equal arrays,
  bit for bit. A mismatch names both
  hosts' torch and CPU capability. Where they differ, CPU kernels of
  another build or SIMD width may round the last bit otherwise with no
  change of code: regenerate the fixture on that host with the same two
  commands, from commit 36e5933, and the test holds the current tree to it
  there. Where they are the same, the one-robot arithmetic changed.
* Every path takes stacked parameters (a fleet) and refuses, with
  ValueError where it starts, a fleet whose scenario axis is not the
  batch: `rollout_init`, `locomotion_init`, `walk_init`,
  `whole_body_init`, `runner_init`, and the whole-body model's functions
  on states of another batch.
* tests/data/unstacked_paths_b.npz holds the same for the functions and
  loops that stacked parameters reach beyond the ADVANCED_TROT MPC loop
  (`_paths_b()`: the force-balance stance, the velocity-mode swing, the
  pose planner, one tick of VELOCITY, POSITION and the walk, the
  whole-body model and its functions, the WBC, the whole-body sim, the
  estimators, the actions, safety and the FSM for each of the five
  robots, and short WBC, whole-body and runner loops), recorded on the
  tree before they took a fleet (commit 9d0e99e) by
      git archive 9d0e99e | tar -x -C <dir>
      sed -i 's/fused_admm(inp.m_inv, /fused_admm(inp.m_inv.transpose(1, 2), /' \
          <dir>/quadruped_tpu_torch/solvers/cone_qp.py
      PYTHONPATH=<dir> python tests/test_torch_fleet_guards.py b
  with the same sed, the same host metadata and the same rule.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "unstacked_paths.npz"
FIXTURE_B = Path(__file__).parent / "data" / "unstacked_paths_b.npz"
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


def _tensor(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _random_obs(params, batch: int, rng):
    """A standing-like RobotObservation [batch] of `params`' robot drawn
    from `rng`: a small tilt, the stand angles plus noise, random
    velocities, two to four contact legs."""
    from quadruped_tpu_torch.control.types import RobotObservation
    from quadruped_tpu_torch.core import se3

    rpy = _tensor(0.05 * rng.standard_normal((batch, 3)))
    quat = se3.rpy_to_quat(rpy)
    r = se3.quat_to_rotmat(quat)
    omega_body = _tensor(0.3 * rng.standard_normal((batch, 3)))
    contact = np.ones((batch, 4), np.float32)
    contact[np.arange(batch), rng.integers(0, 4, batch)] = 0.0
    contact[np.arange(batch), rng.integers(0, 4, batch)] = 0.0
    return RobotObservation(
        base_position=_tensor(np.stack(
            [0.02 * rng.standard_normal(batch), 0.02
             * rng.standard_normal(batch), 0.27 + 0.01
             * rng.standard_normal(batch)], -1)),
        base_rpy=rpy, base_quat=quat,
        base_vel_world=_tensor(0.2 * rng.standard_normal((batch, 3))),
        base_omega_world=torch.einsum("bij,bj->bi", r, omega_body),
        base_omega_body=omega_body,
        joint_angles=params.stand_angles
        + _tensor(0.1 * rng.standard_normal((batch, 12))),
        joint_velocities=_tensor(rng.standard_normal((batch, 12))),
        foot_contact=_tensor(contact),
        foot_forces=_tensor(30.0 + 5.0 * rng.standard_normal((batch, 4))))


def _paths_b() -> dict:
    """The one-robot outputs of the functions that stacked parameters
    reach beyond the ADVANCED_TROT MPC loop, at B=3 for each of the five
    robots on random states, and short one-robot closed loops of those
    paths; only calls that existed on the tree before they took a fleet."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.control import actions, fsm, safety
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import stance_force_balance as sfb
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control import walk_locomotion as walk_mod
    from quadruped_tpu_torch.control import wbc as wbc_mod
    from quadruped_tpu_torch.control.desired_state import (
        ControlMode, TwistCommand, desired_state_init, desired_state_update)
    from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                        locomotion_init,
                                                        locomotion_step)
    from quadruped_tpu_torch.dynamics import floating_base as fb
    from quadruped_tpu_torch.estimation import contact as contact_mod
    from quadruped_tpu_torch.estimation.container import (
        EstimatorConfig, RawSensors, estimator_init, estimator_update)
    from quadruped_tpu_torch.estimation.velocity import \
        VelocityEstimatorConfig
    from quadruped_tpu_torch.exec import RunnerConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
    from quadruped_tpu_torch.gait.scheduler import gait_init, gait_update
    from quadruped_tpu_torch.planner import pose_planner
    from quadruped_tpu_torch.robots import kinematics, named_params
    from quadruped_tpu_torch.sim import whole_body as wb
    from quadruped_tpu_torch.sim.rollout import rollout

    out = {}
    dev, b = "cpu", 3
    rng = np.random.default_rng(11)

    def keep(prefix, value):
        if isinstance(value, torch.Tensor):
            out[prefix] = _np(value)
        elif dataclasses.is_dataclass(value):
            for f in dataclasses.fields(value):
                keep(f"{prefix}/{f.name}", getattr(value, f.name))
        elif isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                keep(f"{prefix}/{i}", v)
        elif value is not None:
            raise TypeError(f"{prefix}: {type(value)}")

    modes = (("velocity", ControlMode.VELOCITY),
             ("position", ControlMode.POSITION))
    for name in ROBOTS:
        p = named_params(name, dev)
        obs = _random_obs(p, b, rng)
        cmd = TwistCommand.constant(
            vx=_tensor(0.3 * rng.random(b)), wz=_tensor(
                0.2 * rng.standard_normal(b)), device=dev)
        des = desired_state_update(desired_state_init(b, 0.27, dev), cmd)
        t = torch.full((b,), 0.1)
        model = fb.build_model(p)
        keep(f"{name}/model", model)
        state = fb.FbState(quat=obs.base_quat, position=obs.base_position,
                           omega_body=obs.base_omega_body,
                           vel_body=obs.base_vel_world, q=obs.joint_angles,
                           dq=obs.joint_velocities)
        f_feet = _tensor(rng.standard_normal((b, 4, 3)) * 20)
        keep(f"{name}/fb", (
            fb.mass_matrix(model, state.q), fb.gravity_force(model, state),
            fb.coriolis_force(model, state),
            fb.contact_jacobians(model, state),
            fb.foot_positions_world(model, state),
            fb.forward_dynamics(model, state, _tensor(
                rng.standard_normal((b, 18))), f_feet)))

        # The force-balance stance: the modes' cold solve, and the walk's
        # warm solve with load ramps and a ground normal.
        fbc = sfb.ForceBalanceConfig()
        forces = sfb.compute_contact_forces(fbc, p, obs, des,
                                            obs.foot_contact)
        walk_fbc = bench_walk.walk_config(None).force_balance
        normal = _tensor(np.array([0.05, -0.03, 1.0]) / np.linalg.norm(
            [0.05, -0.03, 1.0]))
        walk_forces = sfb.compute_contact_forces(
            dataclasses.replace(walk_fbc, track_xy=True, warm_start=True),
            p, obs, des, obs.foot_contact,
            f_min_ratio=_tensor(rng.uniform(0.0, 0.5, (b, 4))),
            f_max_ratio=_tensor(rng.uniform(0.5, 10.0, (b, 4))),
            surface_normal=normal.expand(b, 3), x_warm=forces)
        foot_base = kinematics.foot_positions_in_base_frame(
            p, obs.joint_angles)
        keep(f"{name}/force_balance", (
            forces, sfb.stance_torques(p, obs, forces, obs.foot_contact),
            walk_forces, sfb.mass_matrix(p, foot_base)))

        # The velocity-mode swing law and swing step.
        gait = TROT(dev)
        gs = gait_update(gait, gait_init(gait, b), t, obs.foot_contact)
        vcfg = swing_mod.SwingConfig(mode=ControlMode.VELOCITY)
        keep(f"{name}/swing", (
            swing_mod.raibert_foothold_velocity_mode(vcfg, p, gait, obs, des),
            swing_mod.swing_step(vcfg, p, gait, gs,
                                 swing_mod.swing_init(p, obs), obs, des)))

        # The pose planner, heuristic and SQP.
        feet_world = torch.einsum("bij,blj->bli", obs.rot_body_to_world,
                                  foot_base) + obs.base_position[:, None]
        support = obs.foot_contact
        plan_args = (p, obs.base_position, obs.base_rpy, feet_world,
                     support, torch.zeros_like(obs.base_rpy),
                     torch.full((b,), 0.27))
        keep(f"{name}/pose", (pose_planner.plan_target_pose(*plan_args),
                              pose_planner.plan_target_pose_sqp(*plan_args)))

        # One tick of each force-balance mode and of the walk.
        for mode_name, mode in modes:
            cfg = LocomotionConfig(
                mpc=mpc_mod.MpcConfig(),
                swing=swing_mod.SwingConfig(mode=mode), gait=TROT(dev),
                mode=mode, force_balance=fbc)
            ctrl = locomotion_init(cfg, p, obs)
            keep(f"{name}/{mode_name}",
                 locomotion_step(cfg, p, ctrl, obs, cmd, t)[:2])
        wcfg = bench_walk.walk_config(bench_walk.walk_table(dev))
        walk = walk_mod.walk_init(wcfg, p, obs)
        for k in range(2):
            command, forces, walk = walk_mod.walk_step(
                wcfg, p, walk, obs, cmd, t + 0.002 * k)
            keep(f"{name}/walk/{k}", (command, forces))
        keep(f"{name}/walk/state", walk)

        # The WBC on the observation.
        wcmd = wbc_mod.WbcCommand(
            p_body_des=obs.base_position + 0.01,
            v_body_des=_tensor(0.2 * rng.standard_normal((b, 3))),
            a_body_des=torch.zeros(b, 3), rpy_des=torch.zeros(b, 3),
            omega_des_world=torch.zeros(b, 3),
            p_foot_des=feet_world + 0.02, v_foot_des=torch.zeros(b, 4, 3),
            a_foot_des=torch.zeros(b, 4, 3),
            fr_des=_tensor(np.tile([0.0, 0.0, 30.0], (b, 4, 1))),
            contact_state=obs.foot_contact)
        keep(f"{name}/wbc", wbc_mod.wbc_step(wbc_mod.WbcConfig(), p, model,
                                             obs, wcmd))

        # The whole-body sim: init, observe, two steps on the stand pose.
        contact = wb.ContactModel()
        sim = wb.whole_body_init(p, b)
        stand = actions.keep_stand_command(p, b)
        for _ in range(2):
            sim, flags = wb.whole_body_step(p, model, sim, stand, contact,
                                            0.002)
        keep(f"{name}/whole_body", (sim, flags,
                                    wb.observe(p, model, sim, contact)))

        # Estimation.
        tau = _tensor(rng.standard_normal((b, 12)))
        keep(f"{name}/estimation", (
            contact_mod.external_knee_torque(p, tau, obs.joint_velocities),
            contact_mod.workspace_clip(p, foot_base,
                                       _tensor([0.1, 0.08, 0.1]))))
        ecfg = EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5))
        est = estimator_init(ecfg, b, p.body_height, dev)
        raw = RawSensors(quat=obs.base_quat,
                         acc_body=_tensor(rng.standard_normal((b, 3))),
                         omega_body=obs.base_omega_body,
                         joint_angles=obs.joint_angles,
                         joint_velocities=obs.joint_velocities,
                         foot_forces=obs.foot_forces)
        keep(f"{name}/estimator", estimator_update(
            ecfg, p, est, raw, normalized_phase=gs.normalized_phase,
            desired_stance=obs.foot_contact, dt=0.002))

        # Actions, safety and the FSM.
        q0 = obs.joint_angles
        elapsed = _tensor(rng.uniform(0.0, 3.5, b))
        keep(f"{name}/actions", (
            actions.standup_command(p, q0, elapsed),
            actions.sitdown_command(p, q0, elapsed),
            actions.keep_stand_command(p, b),
            actions.control_foot_command(p, foot_base)))
        loud = dataclasses.replace(stand, tau=_tensor(
            40.0 * rng.standard_normal((b, 12))))
        keep(f"{name}/safety", safety.safe_command(p, obs, loud))
        keep(f"{name}/fsm", fsm.fsm_step(p, fsm.fsm_init(q0), obs,
                                         elapsed, loud))

    # Short one-robot closed loops: the WBC rollout and the whole-body
    # loop of another robot than the A1, and the ground-truth runner in
    # LOCOMOTION on the SRB sim (its MPC solves on ticks 0 and 8).
    trot = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
                            swing=swing_mod.SwingConfig(),
                            gait=ADVANCED_TROT(dev))
    cmd = TwistCommand.constant(vx=np.array([0.1, 0.4], np.float32),
                                device=dev)
    for name in ("go1", "aliengo"):
        p = named_params(name, dev)
        res = rollout(dataclasses.replace(trot, wbc=wbc_mod.WbcConfig(),
                                          use_wbc=True), p, cmd, 6)
        keep(f"loop/{name}/wbc", (res.base_height_trace, res.tau_trace,
                                  res.sim))
        model, contact = fb.build_model(p), wb.ContactModel()
        sim = wb.whole_body_init(p, 2)
        ctrl = locomotion_init(trot, p, wb.observe(p, model, sim, contact))
        for k in range(4):
            obs = wb.observe(p, model, sim, contact)
            command, _, ctrl = locomotion_step(
                trot, p, ctrl, obs, cmd, torch.full((2,), 0.002 * (k + 1)))
            sim, _ = wb.whole_body_step(p, model, sim, command, contact,
                                        0.002)
        keep(f"loop/{name}/whole_body", sim)
    for name in ("a1", "lite3"):
        p = named_params(name, dev)
        config = RunnerConfig(locomotion=trot)
        sim, st = bench_runner.srb_boot(config, p, 2)
        for k in range(10):
            sim, st, command, forces = bench_runner.srb_tick(
                config, p, sim, st, cmd)
        keep(f"loop/{name}/runner", (sim, command, forces))
    return out


def _host() -> dict:
    """What decides the CPU's last bits besides the code."""
    return {"torch": torch.__version__,
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def _assert_bits(fixture: Path, got: dict):
    """`got` equals the arrays of `fixture` bit for bit; a mismatch names
    both hosts."""
    want = np.load(fixture)
    made = {k: str(want[f"meta/{k}"]) for k in _host()}
    hosts = (f"fixture made with {made}, this host {_host()}: "
             + ("the same host, so the arithmetic changed"
                if made == _host() else
                "another host; see the module docstring to regenerate"))
    assert sorted(got) == sorted(k for k in want.files
                                 if not k.startswith("meta/")), hosts
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"{k}; {hosts}")


def test_one_robot_paths_bit_identical():
    """Every one-robot path gives the fixture's bits."""
    _assert_bits(FIXTURE, _paths())


def test_one_robot_paths_b_bit_identical():
    """The functions and loops that stacked parameters reach in VELOCITY,
    POSITION, WALK, the WBC, the whole-body model and sim, the estimators,
    the FSM and the runner give, for each robot alone, the bits of
    tests/data/unstacked_paths_b.npz."""
    _assert_bits(FIXTURE_B, _paths_b())


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


def _refusal(entry: str, batch: int):
    """A call of `entry` with the stacked parameters of two robots on a
    batch of `batch` scenarios."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.control.locomotion import locomotion_init
    from quadruped_tpu_torch.control.walk_locomotion import walk_init
    from quadruped_tpu_torch.dynamics import floating_base as fb
    from quadruped_tpu_torch.exec import RunnerConfig, runner_init
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.sim import whole_body

    params = _fleet()
    obs = _obs(named_params(ROBOTS[0], "cpu"), batch)
    calls = {
        "locomotion_init": lambda: locomotion_init(_locomotion_config(),
                                                   params, obs),
        "walk_init": lambda: walk_init(bench_walk.walk_config(
            bench_walk.walk_table("cpu")), params, obs),
        "whole_body_init": lambda: whole_body.whole_body_init(params, batch),
        "build_model": lambda: fb.mass_matrix(fb.build_model(params),
                                              obs.joint_angles),
        "runner_init": lambda: runner_init(
            RunnerConfig(locomotion=_locomotion_config()), params, obs),
    }
    return calls[entry]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("entry", ["locomotion_init", "walk_init",
                                   "whole_body_init", "build_model",
                                   "runner_init"])
def test_paths_refuse_a_fleet_of_another_size(entry, batch):
    """Every path takes a fleet; each refuses one whose scenario axis is
    not the batch where it starts (a model of two robots refuses states of
    another batch), before a [2] field could broadcast against [1]."""
    with pytest.raises(ValueError, match="of 2 robots"):
        _refusal(entry, batch)()


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
    import sys

    fixture, make = {"a": (FIXTURE, _paths), "b": (FIXTURE_B, _paths_b)}[
        sys.argv[1] if len(sys.argv) > 1 else "a"]
    fixture.parent.mkdir(exist_ok=True)
    np.savez_compressed(fixture, **make(), **{
        f"meta/{k}": np.asarray(v) for k, v in _host().items()})
    print("wrote", fixture, fixture.stat().st_size, "bytes")
