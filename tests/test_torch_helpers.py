"""The port's last public helpers against the JAX package, on the CPU.

`se3.rotmat_to_rpy` / `rotmat_to_quat`, `splines.phase_remap` /
`default_swing_ctrl_z`, `kinematics.estimate_foot_forces_from_torques` /
`estimate_moment`, `swing.mit_foothold` and `srb.srb_dynamics`: the same
numpy-seeded inputs through both packages (the JAX functions under
`jax.vmap` where they take one robot). Tolerance 1e-5 absolute and
relative unless a case states another: both run the same float32
arithmetic and differ in the order of sums and in the libm of the
trigonometric functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.control import swing as j_swing
from quadruped_tpu.core import se3 as j_se3
from quadruped_tpu.core import splines as j_splines
from quadruped_tpu.dynamics import srb as j_srb
from quadruped_tpu.gait import ADVANCED_TROT as JAT
from quadruped_tpu.robots import a1_params as j_a1
from quadruped_tpu.robots import kinematics as j_kin
from quadruped_tpu_torch.control import swing as t_swing
from quadruped_tpu_torch.core import se3 as t_se3
from quadruped_tpu_torch.core import splines as t_splines
from quadruped_tpu_torch.dynamics import srb as t_srb
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots import kinematics as t_kin
from test_torch_force_balance import (_jax_obs_des, _port_obs_des,
                                      _stance_inputs)

torch.set_num_threads(1)


def tt(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rotations(n, seed):
    """n rotation matrices from random RPY, yaw over the full circle and
    pitch to +-1.4 rad (every Shepperd pivot is taken)."""
    rng = np.random.default_rng(seed)
    rpy = np.c_[rng.uniform(-3.0, 3.0, n), rng.uniform(-1.4, 1.4, n),
                rng.uniform(-3.1, 3.1, n)].astype(np.float32)
    return np.asarray(j_se3.rpy_to_rotmat(jnp.asarray(rpy)))


def _joints(n, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.array([0.0, 0.67, -1.25], np.float32), 4) \
        + rng.normal(size=(n, 12)).astype(np.float32) * 0.2
    tau = rng.normal(size=(n, 12)).astype(np.float32) * 8.0
    return q, tau


def case_rotmat():
    r = _rotations(64, 0)
    return [(t_se3.rotmat_to_rpy(tt(r)), j_se3.rotmat_to_rpy(r), {}),
            (t_se3.rotmat_to_quat(tt(r)), j_se3.rotmat_to_quat(r), {})]


def case_splines():
    phi = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    return [(t_splines.phase_remap(tt(phi)), j_splines.phase_remap(phi), {}),
            (t_splines.default_swing_ctrl_z(0.08),
             j_splines.default_swing_ctrl_z(0.08), {"rtol": 0, "atol": 0})]


def case_foot_forces():
    q, tau = _joints(32, 1)
    jp = j_a1()
    return [(t_kin.estimate_foot_forces_from_torques(a1_params("cpu"),
                                                     tt(q), tt(tau)),
             jax.vmap(lambda a, b: j_kin.estimate_foot_forces_from_torques(
                 jp, a, b))(q, tau), {"atol": 1e-4}),
            (t_kin.estimate_moment(a1_params("cpu"), tt(q), tt(tau)),
             jax.vmap(lambda a, b: j_kin.estimate_moment(jp, a, b))(q, tau),
             {"atol": 1e-4})]


def case_mit_foothold():
    obs, des = _stance_inputs(16, 70)
    tobs, tdes = _port_obs_des(obs, des)
    jobs, jdes = _jax_obs_des(obs, des)
    jcfg, tcfg = j_swing.SwingConfig(), t_swing.SwingConfig()
    return [(t_swing.mit_foothold(tcfg, a1_params("cpu"),
                                  ADVANCED_TROT("cpu"), tobs, tdes),
             jax.vmap(lambda o, d: j_swing.mit_foothold(
                 jcfg, j_a1(), JAT(), o, d))(jobs, jdes), {})]


def case_srb_dynamics():
    rng = np.random.default_rng(2)
    n = 16
    x = np.c_[rng.normal(size=(n, 12)) * 0.1,
              np.full(n, j_srb.GRAVITY)].astype(np.float32)
    forces = (rng.normal(size=(n, 4, 3)) * 10.0
              + np.array([0.0, 0.0, 30.0])).astype(np.float32)
    feet = (rng.normal(size=(n, 4, 3)) * 0.03
            + np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                        [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])
            ).astype(np.float32)
    jp, tp = j_a1(), a1_params("cpu")
    want = jax.vmap(lambda a, f, r: j_srb.srb_dynamics(
        a, f, jp.total_inertia, jp.total_mass, r))(x, forces, feet)
    got = t_srb.srb_dynamics(tt(x), tt(forces), tp.total_inertia,
                             tp.total_mass, tt(feet))
    return [(got, want, {"atol": 1e-4})]


CASES = {"rotmat": case_rotmat, "splines": case_splines,
         "foot_forces": case_foot_forces, "mit_foothold": case_mit_foothold,
         "srb_dynamics": case_srb_dynamics}


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_jax(name):
    for i, (got, want, tol) in enumerate(CASES[name]()):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        assert got.shape == want.shape, (name, i, got.shape, want.shape)
        np.testing.assert_allclose(
            np.asarray(got, np.float64), want.astype(np.float64),
            err_msg=f"{name}[{i}]", **{"rtol": 1e-5, "atol": 1e-5, **tol})


def test_rotmat_round_trips():
    """rotmat_to_quat then quat_to_rotmat and rotmat_to_rpy then
    rpy_to_rotmat give the rotation back (float32 roundoff, 1e-5)."""
    r = tt(_rotations(64, 3))
    back = t_se3.quat_to_rotmat(t_se3.rotmat_to_quat(r))
    assert (back - r).abs().max().item() < 1e-5
    back = t_se3.rpy_to_rotmat(t_se3.rotmat_to_rpy(r))
    assert (back - r).abs().max().item() < 1e-5
