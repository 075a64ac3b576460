"""Checkpoint / resume for long batched rollouts (port of
quadruped_tpu/utils/checkpoint.py).

A sweep of a fleet is hours of device time, so `checkpointed_rollout` runs
it in segments and writes the exact carry (`sim.rollout.RolloutCarry`)
after each; re-invoking it after a crash resumes from the newest
checkpoint. The carry after the segments is bitwise the carry of one
uninterrupted run: a segment is the same eager tick loop, and a float32
tensor round-trips through .npz exactly.

Format: one `.npz` per checkpoint, leaves keyed by their field path
(`sim.position`, `ctrl.gait.leg_state`, `step`; dict entries by key). No
pickle: restoring needs a template (`like`) of the same structure, which
supplies the types, devices, shapes and dtypes; missing or extra keys and
any shape or dtype mismatch are refused with the offending keys named. An
`int` leaf (the carry's step counter) is stored as a 0-d int64 array and
comes back as an int. Writes are atomic (a temporary file, then
`os.replace`), so a crash mid-write never corrupts the newest good
checkpoint.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from quadruped_tpu_torch.utils import tree

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _flatten(value) -> dict:
    """{field path: leaf} of the tensors and ints in `value`
    (`tree.leaves`; None leaves, an optional state that is not there, are
    left out)."""
    out = dict(tree.leaves(value))
    for k, leaf in out.items():
        if isinstance(leaf, bool) or not isinstance(leaf,
                                                    (torch.Tensor, int)):
            raise TypeError(f"checkpoint leaf {k or '<root>'}: "
                            f"{type(leaf).__name__} is not a tensor or int")
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int64)


def _spec(leaf) -> tuple:
    """(dtype, shape) a leaf of the template asks the file for."""
    if isinstance(leaf, torch.Tensor):
        return (torch.empty(0, dtype=leaf.dtype).numpy().dtype,
                tuple(leaf.shape))
    return np.dtype(np.int64), ()


def save(path: str, value) -> None:
    """Atomically write `value`'s leaves to `path` (.npz, keyed by field
    path)."""
    arrays = {k: _numpy(v) for k, v in _flatten(value).items()}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore(path: str, like):
    """The checkpoint at `path` in the structure of `like`, whose leaves
    give the types, devices, shapes and dtypes (their values are ignored).
    Raises KeyError naming missing and extra field paths, or ValueError on
    any shape or dtype mismatch: a sweep resumed with another batch size,
    configuration or command fails here, not ticks later."""
    named = _flatten(like)
    with np.load(path, allow_pickle=False) as data:
        saved, want = set(data.files), set(named)
        if saved != want:
            raise KeyError(f"checkpoint {path} does not match template: "
                           f"missing={sorted(want - saved)} "
                           f"extra={sorted(saved - want)}")
        bad = []
        for k, leaf in named.items():
            dtype, shape = _spec(leaf)
            got = data[k]
            if got.shape != shape or got.dtype != dtype:
                bad.append(f"{k}: saved {got.dtype}{got.shape} "
                           f"!= template {dtype}{shape}")
        if bad:
            raise ValueError(
                f"checkpoint {path} shape/dtype mismatch (different batch "
                f"size, config, or command?):\n  " + "\n  ".join(bad))
        leaves = [torch.as_tensor(data[k], device=leaf.device)
                  if isinstance(leaf, torch.Tensor) else int(data[k])
                  for k, leaf in named.items()]
    return tree.replace_leaves(like, leaves)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:012d}.npz")


def latest(directory: str):
    """(path, step) of the newest checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(directory, name), step)
    return best


def checkpointed_rollout(config, params, cmd, total_steps: int,
                         segment_steps: int, directory: str,
                         control_dt: float = 0.002, *, keep: int = 2):
    """The batched closed loop of `cmd`'s scenarios in checkpointed
    segments of `segment_steps` ticks, up to `total_steps`.

    Resumes from the newest checkpoint in `directory` if there is one
    (re-invoke after a crash), else starts fresh. Returns the final
    `RolloutCarry` and the last segment's `RolloutResult` (None when the
    checkpoint already stood at `total_steps`); the traces of earlier
    segments are not kept. `keep` bounds the checkpoints retained."""
    from quadruped_tpu_torch.sim.rollout import rollout_init, rollout_segment

    if total_steps % segment_steps != 0:
        raise ValueError("total_steps must be a multiple of segment_steps "
                         "(segments are one fixed-length tick loop)")
    carry = rollout_init(config, params, cmd.linear.shape[0])
    resumed = latest(directory)
    if resumed is not None:
        carry = restore(resumed[0], carry)
    result = None
    while carry.step < total_steps:
        carry, result = rollout_segment(config, params, cmd, carry,
                                        segment_steps, control_dt)
        save(checkpoint_path(directory, carry.step), carry)
        if keep > 0:
            names = sorted(n for n in os.listdir(directory)
                           if _CKPT_RE.match(n))
            for stale in names[:-keep]:
                os.remove(os.path.join(directory, stale))
    return carry, result
