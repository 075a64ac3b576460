"""URDF loader: `RobotParams` from a robot_description URDF (port of
quadruped_tpu/robots/urdf.py).

The URDF is the single source of truth: `robot_params_from_urdf` parses
link inertials and joint origins with the standard library's XML parser
(no ROS, no xacro engine) and builds the port's `RobotParams` (one robot;
`robots.params.stack` makes a fleet of several), the arithmetic of the
JAX module in float64 numpy and then float32, so both packages give the
same fields from the same file.

Supported naming conventions (auto-detected):
  * Unitree (a1/go1/aliengo/laikago): links `trunk`, `{FR,FL,RR,RL}_hip/
    thigh/calf/foot`; joints `*_hip_joint/_thigh_joint/_calf_joint`.
  * DeepRobotics (lite2/lite3): links `TORSO`, `{FL,FR,HL,HR}_HIP/THIGH/
    SHANK/FOOT`; joints `*_HipX/_HipY/_Knee`.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np
import torch

from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.utils import card

# Our leg order (reference Unitree convention): 0=FR, 1=FL, 2=RR, 3=RL.
_UNITREE_LEGS = ["FR", "FL", "RR", "RL"]
# DeepRobotics order maps H(ind) -> R(ear).
_DEEPROBOTICS_LEGS = ["FR", "FL", "HR", "HL"]


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))


@dataclass
class UrdfJoint:
    name: str
    joint_type: str
    parent: str
    child: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    effort: float
    lower: float
    upper: float


@dataclass
class UrdfModel:
    name: str
    links: dict[str, UrdfLink]
    joints: dict[str, UrdfJoint]

    def child_joint(self, parent: str, joint_type: str | None = None):
        """Joints whose parent link is `parent` (optionally filtered)."""
        return [j for j in self.joints.values()
                if j.parent == parent
                and (joint_type is None or j.joint_type == joint_type)]


def _floats(text: str | None, n: int, default: float = 0.0) -> np.ndarray:
    if not text:
        return np.full(n, default)
    vals = [float(v) for v in text.split()]
    assert len(vals) == n, (text, n)
    return np.asarray(vals)


def load_urdf(path: str) -> UrdfModel:
    """Parse a URDF file into links (inertials) and joints (origins)."""
    root = ET.parse(path).getroot()
    links: dict[str, UrdfLink] = {}
    joints: dict[str, UrdfJoint] = {}

    for el in root.findall("link"):
        name = el.get("name", "")
        link = UrdfLink(name=name)
        inertial = el.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            link.mass = (float(mass_el.get("value", 0.0))
                         if mass_el is not None else 0.0)
            origin = inertial.find("origin")
            if origin is not None:
                link.com = _floats(origin.get("xyz"), 3)
            in_el = inertial.find("inertia")
            if in_el is not None:
                g = lambda k: float(in_el.get(k, 0.0))
                link.inertia = np.array([
                    [g("ixx"), g("ixy"), g("ixz")],
                    [g("ixy"), g("iyy"), g("iyz")],
                    [g("ixz"), g("iyz"), g("izz")],
                ])
        links[name] = link

    for el in root.findall("joint"):
        name = el.get("name", "")
        origin = el.find("origin")
        axis = el.find("axis")
        limit = el.find("limit")
        parent = el.find("parent")
        child = el.find("child")
        def lim(key, default):
            return float(limit.get(key, default)) if limit is not None \
                else default

        joints[name] = UrdfJoint(
            name=name,
            joint_type=el.get("type", "fixed"),
            parent=parent.get("link", "") if parent is not None else "",
            child=child.get("link", "") if child is not None else "",
            origin_xyz=_floats(origin.get("xyz") if origin is not None
                               else None, 3),
            origin_rpy=_floats(origin.get("rpy") if origin is not None
                               else None, 3),
            axis=_floats(axis.get("xyz") if axis is not None else "1 0 0", 3),
            effort=lim("effort", 33.5),
            lower=lim("lower", -math.pi),
            upper=lim("upper", math.pi),
        )
    return UrdfModel(name=root.get("name", ""), links=links, joints=joints)


@dataclass
class _LegChain:
    """Resolved names for one leg's links/joints in either convention."""
    abad_joint: UrdfJoint
    hip_joint: UrdfJoint     # abad -> thigh
    knee_joint: UrdfJoint    # thigh -> calf/shank
    abad_link: UrdfLink
    thigh_link: UrdfLink
    calf_link: UrdfLink
    foot_link: UrdfLink | None
    foot_joint: UrdfJoint | None


def _detect(model: UrdfModel):
    """Return (trunk_name, leg_prefixes, style) for the URDF's convention."""
    if "trunk" in model.links:
        return "trunk", _UNITREE_LEGS, "unitree"
    if "TORSO" in model.links:
        return "TORSO", _DEEPROBOTICS_LEGS, "deeprobotics"
    raise ValueError(
        f"unrecognized URDF convention: links {sorted(model.links)[:8]}...")


def _leg_chain(model: UrdfModel, trunk: str, leg: str,
               style: str) -> _LegChain:
    j = model.joints
    lk = model.links
    if style == "unitree":
        chain = _LegChain(
            abad_joint=j[f"{leg}_hip_joint"],
            hip_joint=j[f"{leg}_thigh_joint"],
            knee_joint=j[f"{leg}_calf_joint"],
            abad_link=lk[f"{leg}_hip"],
            thigh_link=lk[f"{leg}_thigh"],
            calf_link=lk[f"{leg}_calf"],
            foot_link=lk.get(f"{leg}_foot"),
            foot_joint=j.get(f"{leg}_foot_fixed"),
        )
    else:
        chain = _LegChain(
            abad_joint=j[f"{leg}_HipX"],
            hip_joint=j[f"{leg}_HipY"],
            knee_joint=j[f"{leg}_Knee"],
            abad_link=lk[f"{leg}_HIP"],
            thigh_link=lk[f"{leg}_THIGH"],
            calf_link=lk[f"{leg}_SHANK"],
            foot_link=lk.get(f"{leg}_FOOT"),
            foot_joint=j.get(f"{leg}_Ankle") or j.get(f"{leg}_FootJoint"),
        )
    return chain


def _point_mass_inertia(mass: float, r: np.ndarray) -> np.ndarray:
    """Parallel-axis point-mass contribution about the origin."""
    rr = float(r @ r)
    return mass * (rr * np.eye(3) - np.outer(r, r))


def robot_params_from_urdf(
    path: str,
    *,
    template: RobotParams | None = None,
    body_height: float | None = None,
    friction_coef: float = 0.45,
    device=None,
) -> RobotParams:
    """Build `RobotParams` from a quadruped URDF.

    Geometry and mass/inertia come from the URDF. Control-policy numbers
    the URDF cannot know (motor gains, stand/standup/sitdown joint targets,
    CoM trim) are taken from `template` when given, else set to the generic
    defaults used by robots/params.py.

    total_inertia is the composite rotational inertia about the trunk frame
    origin at the nominal stand pose: trunk inertia (parallel-axis shifted
    from its CoM) plus point-mass contributions of every leg link at its
    stand-pose position — the same single-rigid-body lumping the reference's
    YAML `bodyInertia` encodes for the MPC model. The tensors land on the
    card unless `device` says otherwise; several URDFs' parameters stack
    into a fleet with `robots.params.stack`.
    """
    device = card.resolve(device)
    model = load_urdf(path)
    trunk_name, legs, style = _detect(model)
    trunk = model.links[trunk_name]

    # DeepRobotics URDFs hang an extra inertia-only link off the torso.
    extra_mass = 0.0
    extra_inertia = np.zeros((3, 3))
    if style == "deeprobotics" and "INERTIA" in model.links:
        extra = model.links["INERTIA"]
        extra_mass = extra.mass
        extra_inertia = extra.inertia + _point_mass_inertia(extra.mass,
                                                            extra.com)

    chains = [_leg_chain(model, trunk_name, leg, style) for leg in legs]

    hip_offset = np.stack([c.abad_joint.origin_xyz for c in chains])
    hip_length = float(np.mean(np.abs(
        [c.hip_joint.origin_xyz[1] for c in chains])))
    upper_length = float(np.mean(np.abs(
        [c.knee_joint.origin_xyz[2] for c in chains])))
    if chains[0].foot_joint is not None:
        lower_length = float(np.mean(np.abs(
            [c.foot_joint.origin_xyz[2] for c in chains])))
    else:
        # Foot offset folded into the calf link's collision sphere: fall
        # back to the calf CoM placement convention (CoM at mid-link).
        lower_length = float(np.mean(np.abs(
            [2.0 * c.calf_link.com[2] for c in chains])))

    body_mass = trunk.mass + extra_mass
    leg_masses = [
        c.abad_link.mass + c.thigh_link.mass + c.calf_link.mass
        + (c.foot_link.mass if c.foot_link is not None else 0.0)
        for c in chains
    ]
    total_mass = body_mass + float(np.sum(leg_masses))

    # Trunk inertia about the trunk origin.
    body_inertia = trunk.inertia + _point_mass_inertia(trunk.mass, trunk.com) \
        + extra_inertia

    # Composite SRB inertia: add each leg link as a point mass at its
    # stand-pose position in the trunk frame (legs under the hips).
    total_inertia = body_inertia.copy()
    for c, off in zip(chains, hip_offset):
        side = math.copysign(1.0, off[1]) if off[1] != 0 else 1.0
        abad_pos = off + c.abad_link.com
        thigh_pos = off + np.array([0.0, side * hip_length, 0.0]) \
            + c.thigh_link.com
        calf_pos = thigh_pos + np.array([0.0, 0.0, -upper_length]) \
            + c.calf_link.com
        total_inertia += _point_mass_inertia(c.abad_link.mass, abad_pos)
        total_inertia += _point_mass_inertia(c.thigh_link.mass, thigh_pos)
        total_inertia += _point_mass_inertia(c.calf_link.mass, calf_pos)
        if c.foot_link is not None:
            foot_pos = thigh_pos + np.array(
                [0.0, 0.0, -(upper_length + lower_length)])
            total_inertia += _point_mass_inertia(c.foot_link.mass, foot_pos)

    # Per-link chain properties in our FL-leg convention (params.py).
    fl = chains[1]
    links_mass = np.array([fl.abad_link.mass, fl.thigh_link.mass,
                           fl.calf_link.mass])
    links_inertia = np.stack([fl.abad_link.inertia, fl.thigh_link.inertia,
                              fl.calf_link.inertia])
    links_com_pos = np.stack([fl.abad_link.com, fl.thigh_link.com,
                              fl.calf_link.com])

    torque_limit = float(np.median([c.knee_joint.effort for c in chains]))

    if body_height is None:
        body_height = float(template.body_height) if template is not None \
            else 0.95 * (upper_length + lower_length)

    default_hip_position = hip_offset.copy()
    default_hip_position[:, 1] += hip_length * np.sign(hip_offset[:, 1])
    default_hip_position[:, 2] = -body_height

    def _tmpl(attr, fallback):
        if template is not None:
            return getattr(template, attr).detach().cpu().numpy()
        return np.asarray(fallback)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    stand = _tmpl("stand_angles", np.tile([0.0, 0.8, -1.6], 4))
    return RobotParams(
        total_mass=f(total_mass),
        total_inertia=f(total_inertia),
        body_mass=f(body_mass),
        body_inertia=f(body_inertia),
        body_size=f([2 * np.max(np.abs(hip_offset[:, 0])),
                     2 * np.max(np.abs(hip_offset[:, 1])), 0.114]),
        body_height=f(body_height),
        hip_offset=f(hip_offset),
        hip_length=f(hip_length),
        upper_length=f(upper_length),
        lower_length=f(lower_length),
        default_hip_position=f(default_hip_position),
        com_offset=f(_tmpl("com_offset", np.zeros(3))),
        links_mass=f(links_mass),
        links_inertia=f(links_inertia),
        links_com_pos=f(links_com_pos),
        motor_kp=f(_tmpl("motor_kp", np.tile([100.0, 100.0, 100.0], 4))),
        motor_kd=f(_tmpl("motor_kd", np.tile([1.0, 2.0, 2.0], 4))),
        torque_limit=f(min(torque_limit,
                           23.0 if template is None
                           else float(template.torque_limit))),
        stand_angles=f(stand),
        standup_angles=f(_tmpl("standup_angles", np.tile([0.0, 0.9, -1.8],
                                                         4))),
        sitdown_angles=f(_tmpl("sitdown_angles",
                               np.tile([-0.167, 0.935, -2.545], 4))),
        friction_coef=f(friction_coef),
    )
