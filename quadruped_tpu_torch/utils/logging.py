"""Structured run metrics: a JSONL sink, rollout summaries and a profiler
trace (port of quadruped_tpu/utils/logging.py).

`MetricsLogger` appends one JSON record a call, `summarize_rollout` reduces
a batch-first `sim.rollout.RolloutResult` to scalars, and `profile_trace`
records one call under `torch.profiler` into a Chrome trace, the
counterpart of `jax.profiler.trace`.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class MetricsLogger:
    path: str = "/tmp/quadruped_tpu_torch_metrics.jsonl"
    _t0: float = field(default_factory=time.perf_counter)

    def log(self, **metrics):
        """Append {"t": seconds since construction, **metrics} as one JSON
        line (values as float where they convert, else as str); returns
        the record."""
        rec = {"t": round(time.perf_counter() - self._t0, 4)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def summarize_rollout(result) -> dict:
    """Scalar metrics of a RolloutResult (traces [B, T, ...]): the alive
    share, the mean base height over the second half of the ticks, and the
    mean horizontal speed on the last tick. The JAX function reads
    time-first traces ([T, B, ...]); these are the same numbers."""
    alive = _np(result.alive)
    hs = _np(result.base_height_trace)
    vs = _np(result.vel_trace)
    return {
        "alive_fraction": float(np.mean(alive)),
        "mean_height": float(np.mean(hs[:, hs.shape[1] // 2:])),
        "final_speed": float(np.mean(np.linalg.norm(
            vs[:, -1].reshape(-1, 3)[:, :2], axis=-1))),
    }


def profile_trace(fn, args, logdir: str = "/tmp/qtpu_torch_profile") -> str:
    """Record one call fn(*args) under torch.profiler (host operators, and
    the card's kernels when there is a card) and write it as a Chrome
    trace, `logdir/trace.json` (chrome://tracing or Perfetto); returns
    logdir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return logdir
