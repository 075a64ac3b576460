"""Carry state and parameters across from the JAX package, and back to numpy.

`to_torch` walks a dataclass by field name (flax `struct.dataclass`
instances are dataclasses) and builds the port's dataclass of the same
field names: each array leaf goes through `np.asarray` and becomes a
float32 / int32 / bool tensor on the given device; plain Python fields are
kept as they are. No JAX import is needed: numpy does the work.

Batch axis: `batch=N` broadcasts every leaf to a leading scenario axis of
N (one JAX scenario replicated); `batch=None` keeps the leaves' shapes,
which is right both for what the batch shares (`RobotParams`, the
`FloatingBaseModel`, `ContactModel` and `WbcConfig`, whose scalar and [3]
leaves broadcast) and for a pytree that `jax.vmap` already batched along
its leading axis (`FbState`, `WholeBodySimState`, `WbcCommand`, the
controller states: `LocomotionState` with its optional `transition`,
`WalkState`, `PosePlannerState`, `WalkGaitState`, `GaitTransitionState`,
`RunnerState` with its `EstimatorState`, `ControlFsmState`, `RcState`,
`CmuKfState`, `RawSensors`). A field annotated `X | None` recurses into X
when it holds a value; a JAX NamedTuple (`MovingWindowState`) maps field
for field onto the port's dataclass of that name. Leaves land on the card
unless `device` names another device.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from quadruped_tpu_torch.utils import card


def _tensor(value, device, batch):
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int32)
    t = torch.as_tensor(np.array(arr), device=device)
    if batch is not None:
        t = t.expand((batch,) + tuple(t.shape)).contiguous()
    return t


def _dataclass_hint(hint):
    """The dataclass named by a field's annotation (X, or X | None)."""
    if dataclasses.is_dataclass(hint):
        return hint
    return next((a for a in typing.get_args(hint)
                 if dataclasses.is_dataclass(a)), None)


def _is_namedtuple(value) -> bool:
    return isinstance(value, tuple) and hasattr(value, "_fields")


def to_torch(value, cls, *, device=None, batch: int | None = None):
    """An instance of the port's dataclass `cls` from `value`, field by
    field (nested dataclass fields recurse into their annotated type).
    `value` is a dataclass, a NamedTuple or a mapping of field names, such
    as the nested dict that `as_numpy` makes; on the card unless `device`
    says otherwise."""
    device = card.resolve(device)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = (value.get(f.name) if isinstance(value, dict)
             else getattr(value, f.name))
        hint = _dataclass_hint(hints.get(f.name))
        if v is None:
            kwargs[f.name] = None
        elif (dataclasses.is_dataclass(v) or isinstance(v, dict)
              or _is_namedtuple(v)) and hint is not None:
            kwargs[f.name] = to_torch(v, hint, device=device, batch=batch)
        elif isinstance(v, (bool, int, float, str, tuple)):
            kwargs[f.name] = v
        else:
            kwargs[f.name] = _tensor(v, device, batch)
    return cls(**kwargs)


def as_numpy(value):
    """A dataclass (or NamedTuple) of tensors -> nested dict of numpy arrays;
    works on JAX pytrees of arrays and on the port's dataclasses alike."""
    if dataclasses.is_dataclass(value):
        return {f.name: as_numpy(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if _is_namedtuple(value):
        return {k: as_numpy(getattr(value, k)) for k in value._fields}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return np.asarray(value)


def flatten(nested: dict, prefix: str) -> dict:
    """A nested dict of arrays (as_numpy's) -> flat {prefix/a/b: array},
    for np.savez; None leaves are dropped."""
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        elif v is not None:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflatten(arrays, prefix: str) -> dict:
    """The inverse of `flatten` for the keys under `prefix` of a mapping
    such as an np.load result; feed the result to `to_torch`."""
    out: dict = {}
    for key in arrays:
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arrays[key]
    return out
