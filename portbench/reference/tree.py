"""The one traversal of the port's trees (dataclasses, NamedTuples, dicts,
tuples and lists of tensors): `children` / `rebuild` walk a node, `leaves`
/ `replace_leaves` flatten and refill a tree, and per-scenario selection,
maps, stacking, checkpoints, traces and `convert.as_numpy` are built on
them."""

from __future__ import annotations

import dataclasses

import torch


def where(mask: torch.Tensor, a, b):
    """Field-wise `torch.where(mask, a, b)` over two trees of the same
    structure (dataclasses, nested ones included). mask is [B] bool; every
    tensor leaf has the leading scenario axis. Other leaves come from `a`,
    so an optional state that is None in both stays None (the runner's
    hold of `LocomotionState` outside LOCOMOTION, `transition` included).
    This is what `lax.cond` or a tree-mapped `jnp.where` does under
    `jax.vmap` in the JAX package."""
    kids = children(a)
    if kids is None:
        if isinstance(a, torch.Tensor):
            m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
            return torch.where(m, a, b)
        return a
    return rebuild(a, [where(mask, ka, kb)
                       for (_, ka), (_, kb) in zip(kids, children(b))])


def children(x):
    """The (name, sub-tree) pairs of a node in the JAX package's flatten
    order (dataclass and NamedTuple fields as declared, dict keys sorted,
    tuple and list items), or None for a leaf."""
    if dataclasses.is_dataclass(x):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [(k, getattr(x, k)) for k in x._fields]
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return list(enumerate(x))
    return None


def rebuild(x, values: list):
    """A node of x's type and structure with its children replaced, in
    `children` order, by `values`."""
    names = [name for name, _ in children(x)]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **dict(zip(names, values)))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*values)
    if isinstance(x, dict):
        return dict(zip(names, values))
    return type(x)(values)


def leaves(x, sep: str = ".") -> list:
    """The (path, leaf) pairs of x in `children` order, one for every leaf
    that is not None (an optional state that is not there); path is the
    names from the root to the leaf joined by `sep` ("" for a bare leaf).
    What `jax.tree_util.tree_flatten_with_path` gives; checkpoints key the
    carry by these paths ("sim.position", "ctrl.gait.leg_state", "step")."""
    kids = children(x)
    if kids is None:
        return [] if x is None else [("", x)]
    return [(f"{name}{sep}{path}" if path else str(name), leaf)
            for name, kid in kids for path, leaf in leaves(kid, sep)]


def replace_leaves(like, values):
    """`like` with its leaves (those `leaves` gives, in its order) replaced
    by the items of the iterable `values`; None stays None."""
    it = iter(values)

    def put(x):
        kids = children(x)
        if kids is None:
            return None if x is None else next(it)
        return rebuild(x, [put(kid) for _, kid in kids])

    return put(like)


def map_tensors(fn, x):
    """fn applied to every tensor of a dataclass, NamedTuple, dict, tuple or
    list (nested ones included), the structure kept; other leaves are kept
    as they are. What `jax.tree.map` does over the JAX package's
    pytrees."""
    return replace_leaves(x, [fn(v) if isinstance(v, torch.Tensor) else v
                              for _, v in leaves(x)])


def stack(values: list):
    """Trees of one structure stacked leaf by leaf along a new leading
    axis: one value per scenario."""
    columns = zip(*[[v for _, v in leaves(t)] for t in values])
    return replace_leaves(values[0], [torch.stack(c) for c in columns])


def index(x, idx):
    """x[idx] of every tensor of a tree: the scenarios `idx` of a batch.
    Other leaves are kept."""
    return map_tensors(lambda t: t[idx], x)
