"""Per-scenario selection over the port's state dataclasses."""

from __future__ import annotations

import dataclasses

import torch


def where(mask: torch.Tensor, a, b):
    """Field-wise `torch.where(mask, a, b)` over two dataclasses of the same
    type (nested dataclasses included). mask is [B] bool; every tensor
    field has the leading scenario axis. Non-tensor fields come from `a`,
    so an optional state that is None in both stays None (the runner's
    hold of `LocomotionState` outside LOCOMOTION, `transition` included).
    This is what `lax.cond` or a tree-mapped `jnp.where` does under
    `jax.vmap` in the JAX package."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: where(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return torch.where(m, a, b)
    return a


def index(x, idx):
    """Field-wise x[idx] over a dataclass (nested dataclasses included):
    the scenarios `idx` of a batch. Non-tensor fields are kept."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: index(getattr(x, f.name), idx)
            for f in dataclasses.fields(x)})
    return x[idx] if isinstance(x, torch.Tensor) else x
