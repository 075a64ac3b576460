"""Zero-moment point of the cart-table model, and the support margin
(port of quadruped_tpu/estimation/zmp.py)."""

from __future__ import annotations

import torch

G = 9.81


def compute_zmp(com_position: torch.Tensor,      # [..., 3] world
                com_acceleration: torch.Tensor,  # [..., 3] gravity-free
                ) -> torch.Tensor:
    """[..., 2] ZMP in the world frame: com_xy - (z / g) a_xy."""
    z = com_position[..., 2]
    return com_position[..., :2] \
        - (z / G)[..., None] * com_acceleration[..., :2]


def support_margin(zmp_xy: torch.Tensor,                # [..., 2]
                   foot_positions_world: torch.Tensor,  # [..., 4, 3]
                   contact: torch.Tensor,               # [..., 4]
                   ) -> torch.Tensor:
    """[...] mean radius of the contact feet about their centroid minus the
    ZMP's distance from it: negative where the ZMP left the support."""
    n = torch.clamp(torch.sum(contact, dim=-1), min=1.0)
    centroid = torch.sum(foot_positions_world[..., :2] * contact[..., None],
                         dim=-2) / n[..., None]
    radii = torch.linalg.vector_norm(
        (foot_positions_world[..., :2] - centroid[..., None, :])
        * contact[..., None], dim=-1)
    mean_radius = torch.sum(radii, dim=-1) / n
    d = torch.linalg.vector_norm(zmp_xy - centroid, dim=-1)
    return mean_radius - d
