"""The device of the reference's constructors: the one the caller names."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as given; the reference never picks a device itself."""
    if device is None:
        raise ValueError("the reference builds on the device its caller "
                         "names")
    return torch.device(device)
