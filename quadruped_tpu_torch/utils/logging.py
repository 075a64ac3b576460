"""Structured run metrics: a JSONL sink, rollout summaries and a profiler
trace (port of quadruped_tpu/utils/logging.py).

`MetricsLogger` appends one JSON record a call, `summarize_rollout` reduces
a batch-first `sim.rollout.RolloutResult` to scalars, and `profile_trace`
records one call under `torch.profiler` into a Chrome trace, the
counterpart of `jax.profiler.trace`.

`span(name)` names a layer of the port's tick for whatever profiler is
running: the rollout loop (`qtpu.rollout`), the simulator (`qtpu.sim.*`),
the control tick (`qtpu.ctrl`, `.swing`, `.mpc`, `.wbc`), the MPC solve
and its QP stages (`qtpu.mpc.*`, `qtpu.condense`, `qtpu.qp.*`), the
whole-body controller (`qtpu.wbc.model`, the floating-base model built
once a `rollout_segment`; inside `qtpu.ctrl.wbc`, `qtpu.wbc.tasks`, the
task Jacobians and the kinematic cascade, `qtpu.wbc.dynamics`, the mass
matrix, Coriolis and gravity terms, the weighted pseudo-inverse cascade
and the QP's rows, and `qtpu.wbc.qp`, the QP's ADMM solve) and the host's
waits for the device (`qtpu.sync.*`). Under `profile_trace`, or any
`torch.profiler` session that records operators, each span is a range on
the host timeline, on the clock of the card's kernels, around the
operators it ran and their launch calls, which the trace links to their
kernels: open the Chrome trace in Perfetto (ui.perfetto.dev) to follow a
kernel to its layer. With no profiler running a span costs one branch.

Counters beside the spans, plain integers counted on the host whether or
not a profiler runs: `srb_sim_step.eager`, `.captures` and `.replays`
(`sim/srb_sim.py`), and `wbc_step.calls` and `wbc_step.skipped`
(`control/wbc.py`, counted by `locomotion_step`: the ticks with the WBC
configured on which it ran, and those its gate skipped because no scenario
was due).
"""

from __future__ import annotations

import contextlib
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


_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A context manager naming a range of host work `name`: a record
    function in the operators' scope (`RecordScope.FUNCTION`) while a
    profiler is running, else one shared null context.

    The operators' scope, and not the user annotations'
    (`torch.profiler.record_function`), keeps the spans off the device's
    timeline: the profiler mirrors each user annotation there as a
    `gpu_user_annotation` over the kernels launched inside it, and a trace
    that records only user annotations then shows device time where the
    device was idle. A profiler that records operators records the spans;
    one that records only user annotations does not."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _UNTRACED


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
