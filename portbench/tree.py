"""Generic walks over the program's state objects (dataclasses, named
tuples, dicts of tensors), which the harness clones, and the hand-over of
the program's state to the reference through the carry maps of
`reference/carry/`, which are data: a program that lays its state out anew
brings a map of its own, and nothing here changes."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

MAPS = Path(__file__).resolve().parent / "reference" / "carry"


def _fields(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return dict(zip(obj._fields, obj))
    if isinstance(obj, dict):
        return dict(obj)
    return None


def _rebuild(obj, new: dict):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **new)
    if isinstance(obj, dict):
        return new
    return obj._replace(**new)


def clone(obj, device=None):
    """A deep copy of every tensor in `obj` (on `device` where given), the
    structure kept."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device, copy=True)
    fields = _fields(obj)
    if fields is None:
        if isinstance(obj, (list, tuple)):
            return type(obj)(clone(v, device) for v in obj)
        return obj
    return _rebuild(obj, {k: clone(v, device) for k, v in fields.items()})


def leaves(obj, prefix: str = "") -> dict:
    """{dotted field path: leaf} of `obj` (tensors, numbers, None)."""
    fields = _fields(obj)
    if fields is None:
        return {prefix: obj}
    out = {}
    for k, v in fields.items():
        out.update(leaves(v, f"{prefix}.{k}" if prefix else k))
    return out


def carry_maps() -> list:
    """[(name, {reference path: program source})] of every map file of
    `reference/carry/`, in name order. A source is the program's path of
    the field, {"path": ..., "last_axis": [start, stop]} for a slice of a
    program field that holds several of the reference's, or null for a
    field the program no longer carries and the reference keeps at its own
    boot value (so it can only part the two, never hide a gap)."""
    return [(p.stem, json.loads(p.read_text())["fields"])
            for p in sorted(MAPS.glob("*.json"))]


def _take(template, source, have: dict, named: bool):
    """The program's value for one reference leaf, or None where `source`
    does not resolve to a value of the template's shape."""
    key = source["path"] if isinstance(source, dict) else source
    value = have.get(key)
    if isinstance(source, dict) and isinstance(value, torch.Tensor):
        value = value[..., slice(*source["last_axis"])]
    if not isinstance(template, torch.Tensor):
        return value if key in have else None
    if not isinstance(value, torch.Tensor):
        return None
    if value.shape != template.shape:
        if not named or value.numel() != template.numel():
            return None
        value = value.reshape(template.shape)
    return value.to(dtype=template.dtype, device=template.device)


def _fill(template, values: dict, prefix: str = ""):
    fields = _fields(template)
    if fields is None:
        return values[prefix] if prefix in values else template
    return _rebuild(template, {
        k: _fill(v, values, f"{prefix}.{k}" if prefix else k)
        for k, v in fields.items()})


def load(template, program_state) -> tuple:
    """(`template`, one of the reference's state objects, with every leaf
    taken from `program_state`; the name of the carry map that resolved).

    The maps are tried in name order; a leaf the map does not name is read
    from the program's field of the same path, a leaf it names from its
    source (reshaped where the map says so and the sizes agree). The first
    map under which every leaf that is not None resolves wins. Raises
    KeyError naming the leaves that no map resolves: the program's state
    then needs a map of its own under reference/carry/."""
    want = leaves(template)
    have = leaves(program_state)
    misses = {}
    for name, fields in carry_maps():
        got, miss = {}, []
        for path, leaf in want.items():
            source = fields.get(path, path)
            if leaf is None or source is None:
                continue
            value = _take(leaf, source, have, path in fields)
            if value is None:
                miss.append(path)
            else:
                got[path] = value
        if not miss:
            return _fill(template, got), name
        misses[name] = miss
    raise KeyError(f"no carry map in {MAPS} resolves the reference's state "
                   f"from the program's; unresolved per map: {misses}")
