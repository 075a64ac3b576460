"""6-D spatial (Plücker) algebra, batched (a frozen copy of the port's twin of quadruped_tpu/dynamics/spatial.py).

Motion vectors are [angular(3); linear(3)]. A spatial transform X(E, r)
maps motion vectors from frame A to frame B, E = B_R_A and r the origin
of B in A:  X = [[E, 0], [-E skew(r), E]]. Force vectors transform by the
inverse transpose. Every function broadcasts over leading axes; the small
products are the broadcast-reduce `se3.matmul3`, as in the JAX module.
"""

from __future__ import annotations

import torch

from portbench.reference.se3 import matmul3, rot_x, rot_y, rot_z, skew


def _blocks(tl, tr, bl, br) -> torch.Tensor:
    top = torch.cat([tl, tr], dim=-1)
    bottom = torch.cat([bl, br], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def spatial_transform(e: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 6, 6] motion transform."""
    batch = torch.broadcast_shapes(e.shape[:-2], r.shape[:-1])
    e = e.expand(batch + (3, 3))
    zero = torch.zeros_like(e)
    return _blocks(e, zero, -matmul3(e, skew(r)), e)


def rotation_part(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0:3, 0:3]


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """crm(v) @ m without forming the 6x6."""
    w, vl = v[..., 0:3], v[..., 3:6]
    mw, ml = m[..., 0:3], m[..., 3:6]
    cross = torch.linalg.cross
    return torch.cat([cross(w, mw), cross(vl, mw) + cross(w, ml)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """crf(v) @ f."""
    w, vl = v[..., 0:3], v[..., 3:6]
    fw, fl = f[..., 0:3], f[..., 3:6]
    cross = torch.linalg.cross
    return torch.cat([cross(w, fw) + cross(vl, fl), cross(w, fl)], dim=-1)


def joint_transform_revolute(axis: int, theta: torch.Tensor) -> torch.Tensor:
    """Rotation-only transform of a revolute joint about x/y/z; the joint
    rotation enters as E = R(theta)^T (Featherstone's convention)."""
    e = (rot_x, rot_y, rot_z)[axis](theta).transpose(-1, -2)
    zero = torch.zeros_like(e)
    return _blocks(e, zero, zero, e)


def joint_motion_subspace(axis: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """[6] motion subspace S of a revolute joint about x/y/z."""
    s = torch.zeros(6, dtype=dtype, device=device)
    s[axis] = 1.0
    return s


def spatial_inertia(mass, com: torch.Tensor,
                    i_com: torch.Tensor) -> torch.Tensor:
    """Spatial inertia from mass, CoM offset and rotational inertia about
    the CoM: [[I_com + m c^ c^T, m c^], [m c^T, m 1]]."""
    c = skew(com)
    ct = c.transpose(-1, -2)
    m = torch.as_tensor(mass, dtype=com.dtype, device=com.device)[..., None,
                                                                  None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    return _blocks(i_com + m * (c @ ct), m * c, m * ct, m * eye)


def flip_inertia_along_y(mass, com: torch.Tensor, i_com: torch.Tensor):
    """Mirror a link's inertial properties across the XZ plane (right-leg
    links from the left-leg catalog values)."""
    com_f = com * torch.as_tensor([1.0, -1.0, 1.0], dtype=com.dtype,
                                  device=com.device)
    flip = torch.as_tensor([[1.0, -1.0, 1.0],
                            [-1.0, 1.0, -1.0],
                            [1.0, -1.0, 1.0]], dtype=i_com.dtype,
                           device=i_com.device)
    return mass, com_f, i_com * flip
