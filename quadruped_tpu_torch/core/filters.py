"""First-order command filter (port of quadruped_tpu/core/filters.py::low_pass)."""

from __future__ import annotations

import torch


def low_pass(prev: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """First-order low-pass: alpha*prev + (1-alpha)*x."""
    return alpha * prev + (1.0 - alpha) * x
