"""Rollout trace recording: compact on-disk capture of batched runs (port of
quadruped_tpu/utils/trace.py).

A trace is whatever tree of per-tick arrays a rollout emits (the port's
dataclasses and NamedTuples, dicts, tuples and lists of tensors or numpy
arrays). `save_trace` writes its leaves to one compressed .npz with a
JSON manifest of their field paths (`utils.tree.leaves`); `load_trace`
reads them back, into the structure of a template when one is given. Leaves are numbered in the
JAX package's flatten order (fields in declaration order, dict keys
sorted), so a trace of either package reads into the other's tree of the
same fields; `compare_traces` is the golden-trace regression primitive.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from quadruped_tpu_torch.utils import tree as trees


def _leaves(value) -> list:
    return [leaf for _, leaf in trees.leaves(value)]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_trace(path: str, tree, meta: dict | None = None) -> str:
    """Save a tree of arrays to `path` (.npz) with a manifest of its leaves'
    field paths."""
    named = trees.leaves(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, (_, x) in enumerate(named)}
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"treedef": [p for p, _ in named], "n_leaves": len(named),
                    "meta": meta or {}}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_trace(path: str, like=None):
    """(tree, meta): with `like` (a tree of the same structure) the arrays
    are put back into that structure, as numpy arrays; otherwise the tree
    is the list of arrays in flatten order."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    if like is not None:
        if len(_leaves(like)) != len(leaves):
            raise ValueError(f"trace {path} has {len(leaves)} leaves, the "
                             f"template {len(_leaves(like))}")
        return trees.replace_leaves(like, leaves), manifest["meta"]
    return leaves, manifest["meta"]


def compare_traces(a, b, atol: float = 1e-5) -> dict:
    """Leaf-wise max |a - b| of two traces of the same structure, their
    largest ("max") and whether it is within `atol`."""
    diffs = {}
    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b))):
        diffs[f"leaf_{i}"] = float(np.max(np.abs(_numpy(x) - _numpy(y))))
    diffs["max"] = max(diffs.values()) if diffs else 0.0
    diffs["within_tol"] = diffs["max"] <= atol
    return diffs
