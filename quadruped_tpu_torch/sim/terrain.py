"""Terrain height fields for the batched simulators (port of quadruped_tpu/sim/terrain.py).

PLANE, SLOPE, STAIRS, GAPS (plum piles) and ROUGH as height functions
z(x, y) that close over their parameters. x and y are [B, ...] tensors
(the feet of each scenario); a parameter is a number, shared by the batch,
or a [B] tensor, one value per scenario (`gaps` takes [K] or [B, K] gap
centres).
"""

from __future__ import annotations

import math

import torch


class TerrainType:
    PLANE = 0
    SLOPE = 1
    STAIRS = 2
    GAPS = 3
    ROUGH = 4


def _param(value, x: torch.Tensor, trailing: int = 0) -> torch.Tensor:
    """`value` as a tensor on x's device that broadcasts against x: a [B]
    (or [B, K] with trailing=1) parameter gets unit axes after the batch."""
    p = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    if p.ndim > trailing:
        extra = x.ndim - p.ndim
        p = p.reshape(p.shape[:p.ndim - trailing] + (1,) * extra
                      + p.shape[p.ndim - trailing:])
    return p


def plane(height=0.0):
    def f(x, y):
        return torch.zeros_like(x) + _param(height, x)

    return f


def slope(pitch=0.1, height=0.0):
    """Incline rising along +x at `pitch` radians."""

    def f(x, y):
        return _param(height, x) + torch.tan(_param(pitch, x)) * x

    return f


def stairs(step_length=0.25, step_height=0.06, start_x=0.5):
    def f(x, y):
        n = torch.floor(torch.clamp(x - _param(start_x, x), min=0.0)
                        / _param(step_length, x))
        return n * _param(step_height, x)

    return f


def gaps(gap_centers=(1.0, 1.6), gap_width=0.12, depth=0.5):
    """Plum-pile style gaps: the ground drops `depth` inside each strip."""

    def f(x, y):
        centers = _param(gap_centers, x[..., None], trailing=1)
        in_gap = torch.any(torch.abs(x[..., None] - centers)
                           < _param(gap_width, x[..., None]) / 2, dim=-1)
        return torch.where(in_gap, -_param(depth, x), torch.zeros_like(x))

    return f


def rough(amplitude=0.02, wavelength=0.3):
    """Deterministic sinusoidal roughness."""

    def f(x, y):
        wl = _param(wavelength, x) if torch.is_tensor(wavelength) \
            else wavelength
        k = 2 * math.pi / wl
        return _param(amplitude, x) * (torch.sin(k * x)
                                       * torch.cos(0.7 * k * y))

    return f


def named(terrain_type: int, **kw):
    return {TerrainType.PLANE: plane, TerrainType.SLOPE: slope,
            TerrainType.STAIRS: stairs, TerrainType.GAPS: gaps,
            TerrainType.ROUGH: rough}[terrain_type](**kw)
