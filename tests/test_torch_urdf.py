"""The port's URDF loader (quadruped_tpu_torch/robots/urdf.py) against the
JAX package's robots/urdf.py (CPU).

The JAX tests read the reference's robot_description URDFs and skip where
those are absent; this file writes two small URDFs into tmp_path, one in
each naming convention (Unitree: `trunk`, `FR_hip_joint`...; DeepRobotics:
`TORSO`, `FL_HipX`..., with the extra `INERTIA` link), with an A1's and a
Lite3's masses and joint origins, parses them with both packages and holds
the `RobotParams` equal field by field, with and without a template. The
loaded robots then stack into a fleet (`robots.params.stack`) beside the
factories' and trot a few ticks on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.robots import params as tparams
from quadruped_tpu_torch.robots import urdf as turdf

torch.set_num_threads(1)

# name: (leg prefixes, link names, joint names, foot joint, trunk link,
#        hip x, hip y, abad y, thigh z, calf z, link masses, trunk mass)
STYLES = {
    "unitree": (("FR", "FL", "RR", "RL"), ("hip", "thigh", "calf", "foot"),
                ("hip_joint", "thigh_joint", "calf_joint"), "foot_fixed",
                "trunk", 0.1805, 0.047, 0.0838, 0.2, 0.2,
                (0.696, 1.013, 0.166, 0.06), 6.0),
    "deeprobotics": (("FR", "FL", "HR", "HL"),
                     ("HIP", "THIGH", "SHANK", "FOOT"),
                     ("HipX", "HipY", "Knee"), "Ankle", "TORSO", 0.1745,
                     0.062, 0.0985, 0.20, 0.21,
                     (0.428, 0.61, 0.145, 0.0), 4.0),
}


def _inertial(mass, com, diag, off=0.0):
    ixx, iyy, izz = diag
    return (f'<inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/>'
            f'<mass value="{mass}"/><inertia ixx="{ixx}" ixy="{off}" '
            f'ixz="{-off}" iyy="{iyy}" iyz="{off / 2}" izz="{izz}"/>'
            f'</inertial>')


def _write_urdf(path, style: str) -> str:
    (legs, links, joints, foot_joint, trunk, hx, hy, abad_y, thigh_z,
     calf_z, masses, trunk_mass) = STYLES[style]
    rng = np.random.default_rng(len(style))
    parts = [f'<robot name="{style}_test">',
             f'<link name="{trunk}">'
             + _inertial(trunk_mass, (0.008, 0.002, 0.0005),
                         (0.0158, 0.0377, 0.0456), 1e-5) + '</link>']
    if style == "deeprobotics":
        parts.append('<link name="INERTIA">'
                     + _inertial(3.5, (0.01, 0.0, -0.02), (0.02, 0.06, 0.07))
                     + '</link>')
    for leg in legs:
        sx = 1.0 if leg[0] == "F" else -1.0
        sy = 1.0 if leg[1] == "L" else -1.0
        names = [f"{leg}_{k}" for k in links]
        for k, (name, mass) in enumerate(zip(names, masses)):
            com = rng.normal(size=3) * 0.01 + (0, 0, -0.1 * (k == 2))
            diag = 1e-3 * (1.0 + rng.random(3))
            parts.append(f'<link name="{name}">'
                         + (_inertial(mass, com, diag, 2e-6) if mass else "")
                         + '</link>')
        origins = [(sx * hx, sy * hy, 0.0), (0.0, sy * abad_y, 0.0),
                   (0.0, 0.0, -thigh_z), (0.0, 0.0, -calf_z)]
        parents = [trunk] + names[:3]
        jnames = [f"{leg}_{j}" for j in joints] + [f"{leg}_{foot_joint}"]
        for k, (jn, parent, child, xyz) in enumerate(zip(
                jnames, parents, names, origins)):
            kind = "fixed" if k == 3 else "revolute"
            axis = "1 0 0" if k == 0 else "0 1 0"
            limit = ('' if k == 3 else
                     f'<limit effort="{33.5 + 2 * k}" lower="-1.0" '
                     f'upper="1.0" velocity="21"/>')
            parts.append(f'<joint name="{jn}" type="{kind}">'
                         f'<origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" '
                         f'rpy="0 0 0"/><parent link="{parent}"/>'
                         f'<child link="{child}"/><axis xyz="{axis}"/>'
                         f'{limit}</joint>')
    parts.append("</robot>")
    path.write_text("\n".join(parts))
    return str(path)


def _assert_equal(port, ref):
    for f in dataclasses.fields(tparams.RobotParams):
        got = getattr(port, f.name)
        assert got.dtype == torch.float32, f.name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("style,robot", [("unitree", "a1"),
                                         ("deeprobotics", "lite3")])
def test_urdf_params_equal_jax(tmp_path, style, robot):
    from quadruped_tpu.robots import named_params as j_named
    from quadruped_tpu.robots import urdf as jurdf

    path = _write_urdf(tmp_path / f"{style}.urdf", style)
    m = turdf.load_urdf(path)
    assert STYLES[style][4] in m.links
    _assert_equal(turdf.robot_params_from_urdf(path, device="cpu"),
                  jurdf.robot_params_from_urdf(path))
    port = turdf.robot_params_from_urdf(
        path, template=tparams.named_params(robot, "cpu"), friction_coef=0.5,
        device="cpu")
    _assert_equal(port, jurdf.robot_params_from_urdf(
        path, template=j_named(robot), friction_coef=0.5))
    # Leg order is ours (FR, FL, RR, RL) in both conventions.
    ho = port.hip_offset.numpy()
    assert (ho[:2, 0] > 0).all() and (ho[2:, 0] < 0).all()
    assert ho[0, 1] < 0 < ho[1, 1] and ho[2, 1] < 0 < ho[3, 1]


def test_urdf_robots_stack_into_a_fleet(tmp_path):
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.sim.rollout import rollout

    robots = [
        turdf.robot_params_from_urdf(
            _write_urdf(tmp_path / f"{s}.urdf", s),
            template=tparams.named_params(r, "cpu"), device="cpu")
        for s, r in (("unitree", "a1"), ("deeprobotics", "lite3"))]
    fleet = tparams.stack(robots + [tparams.a1_params("cpu")])
    assert fleet.stacked and fleet.links_inertia.shape == (3, 3, 3, 3)
    assert torch.equal(fleet.total_inertia[1], robots[1].total_inertia)
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=12),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT("cpu"))
    res = rollout(config, fleet, TwistCommand.constant(
        vx=0.2, batch=3, device="cpu"), 16)
    assert res.alive.min().item() == 1.0
    assert torch.isfinite(res.forces_trace).all()
    # Each robot stands at its own height (the Lite3 template's 0.29 m,
    # the A1's 0.28 m).
    np.testing.assert_allclose(res.base_height_trace[:, -1].numpy(),
                               fleet.body_height.numpy(), atol=0.02)
