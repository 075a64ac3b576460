"""The port's whole-body controller held to the benchmark's plain-torch
reference (`portbench/reference/`), with no JAX.

`portbench/reference/` is a frozen plain-torch copy of the port's closed
loop that imports nothing of the port, and the benchmark's check of the
Aliengo MPC+WBC cell holds the program to it on the card. Here, on the
CPU, the same holds for the WBC alone and for the cell's whole path:

* `control/wbc.py::wbc_step` on seeded Aliengo states at B = 8 (stance and
  swing mixed: trot pairs on every other row, full stance on the rest;
  tilted, moving bases; feet targets near the feet) against
  `portbench.reference.wbc.wbc_step` on the same inputs, the robot and
  the WBC gains built from the cell's configuration file by each side's
  own constructors: `q_des`, `dq_des` and `tau_ff` within TOL, and the
  port in float32 also within TOL of the reference in float64.
* `harness.rehearse` of the cell `aliengo-wbc-h5.sweep-b131072` at its
  driver's CPU size (`portbench/tests/cases.py`): `correct`, with no
  failed robot-tick.
* Two degraded programs fail TOL against the reference: the WBC QP at 10
  ADMM iterations in place of the configuration's 50, and the mass matrix
  rounded through bfloat16.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import harness, program
from portbench.reference import floating_base as ref_fb
from portbench.reference import obs_types as ref_types
from portbench.reference import rollout as ref_rollout
from portbench.reference import wbc as ref_wbc
from portbench.tests import cases
from quadruped_tpu_torch.control import wbc
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.robots import kinematics

torch.set_num_threads(1)

CELL = "aliengo-wbc-h5.sweep-b131072"
CONFIG = json.loads((harness.PACKAGE / "configs"
                     / "aliengo-trot-mpc-wbc-h5.json").read_text())
B = 8
SEED = 20261018
OUTPUTS = ("q_des", "dq_des", "tau_ff")
# Two float32 implementations of this arithmetic lie apart by rounding
# alone: the port against the JAX package and each against a float64 run
# read at most 2.5e-5 rad, 1.3e-4 rad/s and 3.9e-4 N m (A1,
# tests/test_torch_wbc.py, whose WBC_TOL these are), and the port here
# against the reference in float64 5.5e-5, 5.6e-5 and 2.1e-4 (at SEED;
# 3.8e-5, 5.6e-5 and 4.1e-4 at most over other seeds, on a CPU). The
# damped pseudo-inverses (1e-6 on J J^T, 1e-4 on J A^-1 J^T after
# `inv_spd` of the 18 x 18 mass matrix) amplify that rounding, hence about
# five times it. The port against the float32 reference reads 0 on the
# CPU (the same operations in the same order); the degraded programs read
# 9.1e-3 (QP at 10 iterations) and 7.5e-3 N m (bfloat16 mass matrix) in
# tau_ff at SEED, 6.2e-3 at least over other seeds: three times TOL.
TOL = {"q_des": 1e-4, "dq_des": 5e-4, "tau_ff": 2e-3}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _states(seed: int) -> dict:
    """Seeded Aliengo states and WBC targets as numpy arrays."""
    rng = np.random.default_rng(seed)
    stand = np.asarray(CONFIG["robot"]["stand_angles_leg"])
    rpy = rng.normal(size=(B, 3)) * [0.05, 0.05, 0.3]
    contact = np.ones((B, 4))
    trot = rng.random(B // 2) < 0.5
    contact[0::2] = np.where(trot[:, None], [1, 0, 0, 1], [0, 1, 1, 0])
    return {
        "q": np.tile(stand, (B, 4)) + rng.normal(size=(B, 12)) * 0.05,
        "dq": rng.normal(size=(B, 12)) * 0.2,
        "rpy": rpy,
        "pos": np.c_[rng.normal(size=(B, 2)) * 0.1,
                     CONFIG["robot"]["body_height"]
                     + rng.normal(size=B) * 0.01],
        "vel": np.c_[rng.uniform(0.0, 0.6, B), rng.normal(size=B) * 0.05,
                     rng.normal(size=B) * 0.02],
        "omega": rng.normal(size=(B, 3)) * 0.1,
        "contact": contact,
        "p_body_off": rng.normal(size=(B, 3)) * 0.01,
        "p_foot_off": rng.normal(size=(B, 4, 3)) * 0.02,
        "v_foot": rng.normal(size=(B, 4, 3)) * 0.2,
        "a_foot": rng.normal(size=(B, 4, 3)),
        "fr_noise": rng.normal(size=(B, 4, 3)) * 3.0,
    }


def _inputs(s: dict, params, obs_type, cmd_type):
    """(obs, cmd) of one side, from the port's kinematics (the feet the
    targets lie near; the same numbers on both sides)."""
    quat = se3.rpy_to_quat(_f32(s["rpy"]))
    rot = se3.quat_to_rotmat(quat)
    omega_body = _f32(s["omega"])
    contact = _f32(s["contact"])
    obs = obs_type(
        base_position=_f32(s["pos"]), base_rpy=_f32(s["rpy"]),
        base_quat=quat, base_vel_world=_f32(s["vel"]),
        base_omega_world=torch.einsum("bij,bj->bi", rot, omega_body),
        base_omega_body=omega_body, joint_angles=_f32(s["q"]),
        joint_velocities=_f32(s["dq"]), foot_contact=contact,
        foot_forces=50.0 * contact)
    feet = obs.base_position[:, None] + torch.einsum(
        "bij,blj->bli", rot, kinematics.foot_positions_in_base_frame(
            params, obs.joint_angles))
    fz = CONFIG["robot"]["total_mass"] * 9.81 / contact.sum(-1)
    fr = (torch.stack([torch.zeros(B, 4), torch.zeros(B, 4),
                       fz[:, None].expand(B, 4)], -1)
          + _f32(s["fr_noise"])) * contact[..., None]
    cmd = cmd_type(
        p_body_des=obs.base_position + _f32(s["p_body_off"]),
        v_body_des=obs.base_vel_world + 0.05,
        a_body_des=torch.zeros(B, 3),
        rpy_des=_f32(s["rpy"]) * torch.tensor([0.0, 0.0, 1.0]),
        omega_des_world=torch.zeros(B, 3),
        p_foot_des=feet + _f32(s["p_foot_off"]), v_foot_des=_f32(s["v_foot"]),
        a_foot_des=_f32(s["a_foot"]), fr_des=fr, contact_state=contact)
    return obs, cmd


def _f64(x):
    """A copy of a reference input with every floating tensor in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _f64(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


@pytest.fixture(scope="module")
def sides():
    """(port_step, the WBC gains, reference outputs in float32, in
    float64): `port_step(config)` runs the port's `wbc_step` on the port's
    inputs."""
    cfg, params = program.locomotion(CONFIG, "cpu")
    ref_cfg, ref_params = ref_rollout.build(CONFIG, "cpu")
    s = _states(SEED)
    obs, cmd = _inputs(s, params, RobotObservation, wbc.WbcCommand)
    r_obs, r_cmd = _inputs(s, params, ref_types.RobotObservation,
                           ref_wbc.WbcCommand)
    model, r_model = fb.build_model(params), ref_fb.build_model(ref_params)
    ref = ref_wbc.wbc_step(ref_cfg.wbc, ref_params, r_model, r_obs, r_cmd)
    ref64 = ref_wbc.wbc_step(ref_cfg.wbc, _f64(ref_params), _f64(r_model),
                             _f64(r_obs), _f64(r_cmd))

    def port_step(config):
        return wbc.wbc_step(config, params, model, obs, cmd)

    assert cfg.wbc.qp_iters == ref_cfg.wbc.qp_iters == 50
    return (port_step, cfg.wbc, dict(zip(OUTPUTS, ref)),
            dict(zip(OUTPUTS, ref64)))


def _gaps(out, ref) -> dict:
    return {k: float((o.double() - ref[k].double()).abs().max())
            for k, o in zip(OUTPUTS, out)}


def test_the_states_mix_stance_and_swing():
    s = _states(SEED)
    assert (s["contact"].sum(-1) == 2).sum() == B // 2
    assert (s["contact"].sum(-1) == 4).sum() == B // 2


@pytest.mark.parametrize("name", OUTPUTS)
def test_wbc_step_matches_the_plain_reference(sides, name):
    port_step, config, ref, ref64 = sides
    out = dict(zip(OUTPUTS, port_step(config)))
    assert torch.isfinite(out[name]).all()
    assert float(out[name].abs().max()) > 0.0
    got = _gaps(out.values(), ref)[name]
    assert got <= TOL[name], (name, got)
    got64 = _gaps(out.values(), ref64)[name]
    assert got64 <= TOL[name], (name, got64)


def _qp_at_10_iterations(port_step, config, monkeypatch):
    return port_step(dataclasses.replace(config, qp_iters=10))


def _mass_matrix_in_bf16(port_step, config, monkeypatch):
    mass_matrix = fb.mass_matrix
    monkeypatch.setattr(fb, "mass_matrix", lambda model, q: mass_matrix(
        model, q).to(torch.bfloat16).to(torch.float32))
    return port_step(config)


@pytest.mark.parametrize("degrade", [_qp_at_10_iterations,
                                     _mass_matrix_in_bf16],
                         ids=["qp_10_iterations", "mass_matrix_bf16"])
def test_a_degraded_program_fails_the_same_tolerances(sides, degrade,
                                                      monkeypatch):
    port_step, config, ref, _ = sides
    gaps = _gaps(degrade(port_step, config, monkeypatch), ref)
    assert any(gaps[k] > TOL[k] for k in OUTPUTS), gaps


def test_rehearsal_of_the_cell_is_correct():
    r = harness.rehearse(CELL, seed=2 ** 31 + 19,
                         overrides=cases.small(CELL))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"robot_s_per_s", "setup_s"}
