"""The traced window of a `--trace 1` run: torch.profiler over a fixed
number of the window's units, reduced to device intervals, host launch
calls and the harness's own host ranges.

A unit is what a driver repeats (a segment, a tick, an update). The window
is the host range `portbench.window`, each unit the range `portbench.unit`;
the window ends after a synchronize, so its device work lies inside it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "portbench.window"
UNIT = "portbench.unit"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host calls that put work on the device: kernel launches and graph
# launches (one each), whether through the runtime or the driver API.
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""

    window: tuple[float, float]
    units: int
    unit_spans: np.ndarray          # [U, 2]
    device: list = field(default_factory=list)   # (start, end, name)
    launches: np.ndarray = None     # [L] start of each launch call

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> np.ndarray:
        """[K, 2] union of the device intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.asarray(merged, dtype=np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float(np.sum(b[:, 1] - b[:, 0]))

    def launches_in_units(self) -> int:
        """Launch calls whose start lies inside a unit's host range."""
        if self.launches is None or len(self.launches) == 0:
            return 0
        starts = np.sort(self.launches)
        return int(sum(np.searchsorted(starts, e) - np.searchsorted(starts, s)
                       for s, e in self.unit_spans))

    def device_time(self, contains: str) -> tuple[float, int]:
        """(summed seconds, count) of device events whose name holds
        `contains`."""
        hits = [e - s for s, e, name in self.device if contains in name]
        return float(sum(hits)), len(hits)

    def device_ops(self, top: int = 10) -> list:
        totals: dict = {}
        for s, e, name in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        return sorted(([k[:200], v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle gaps of the window summed by the device operation whose
        start ended each ("before <op>": the host was still launching the
        work up to it), and the gap after the last device work."""
        busy = self.busy_intervals()
        if len(busy) == 0:
            return [["no device work", self.window_s]]
        lo, hi = self.window
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[:, 1] - edges[:, 0]
        firsts = {}
        for s, _, name in sorted(self.device):
            firsts.setdefault(max(s, lo), name)
        totals: dict = {}
        for g in np.flatnonzero(gaps > 0):
            if g < len(busy):
                name = "before " + firsts[float(edges[g, 1])]
            else:
                name = "after the last device work"
            totals[name] = totals.get(name, 0.0) + float(gaps[g])
        return sorted(([k[:200], v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]


def _kind(ev) -> str:
    try:
        return str(ev.activity_type())
    except AttributeError:
        return ""


def reduce(events) -> Trace:
    """A Trace from the profiler's kineto events."""
    window, spans, device, launches = None, [], [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        kind = _kind(ev)
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if kind in DEVICE_KINDS or (not kind and on_device
                                    and not name.startswith("portbench.")):
            device.append((start, end, name))
        elif on_device:
            continue
        elif name == WINDOW:
            window = (start, end)
        elif name == UNIT:
            spans.append((start, end))
        elif name in LAUNCH_NAMES:
            launches.append(start)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window range")
    return Trace(window=window, units=len(spans),
                 unit_spans=np.asarray(spans, dtype=np.float64).reshape(-1, 2),
                 device=device, launches=np.asarray(launches))


class Tracer:
    """Profiles the first `units` units of a window when `enabled`; a
    no-op otherwise. A driver calls `unit()` around each unit; the harness
    reads `trace` after the window."""

    def __init__(self, enabled: bool, units: int, device: torch.device):
        self.enabled = enabled
        self.units = units
        self.device = device
        self.done = 0
        self.trace = None
        self.wall_s = None
        self.stop_s = 0.0
        self._t = None
        self._stopped = None
        self._window = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self):
        """The lightest trace that counts launches: the device's activity
        (kernels, copies, the runtime's launch calls) and the harness's own
        ranges, with no operator, shape or stack recording. What remains is
        CUPTI's own cost on each launch, which still slows a launch-bound
        unit: the run prints it (`harness._trace_cost`)."""
        from torch.autograd import (_enable_profiler, _prepare_profiler,
                                    profiler)
        from torch._C._profiler import RecordScope
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"
        prof = profiler.profile(use_device="cuda" if cuda else None,
                                use_kineto=True)
        config, acts = prof.config(), prof.kineto_activities
        self._sync()
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        self._t = time.perf_counter()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def _stop(self):
        from torch.autograd import _disable_profiler
        self._sync()
        self._window.__exit__(None, None, None)
        self.wall_s = time.perf_counter() - self._t
        self._stopped = _disable_profiler()
        self.stop_s = time.perf_counter() - self._t - self.wall_s
        self._window = None

    @contextlib.contextmanager
    def unit(self):
        """Around one unit of the window."""
        if not self.enabled or self.done >= self.units:
            yield
            return
        from torch.profiler import record_function
        if self.done == 0:
            self._start()
        with record_function(UNIT):
            yield
        self.done += 1
        if self.done == self.units:
            self._stop()

    def close(self):
        """After the window: stop a trace the window ended before `units`
        units, and reduce the profiler's events."""
        if self._window is not None:
            self._stop()
        if self._stopped is not None:
            self.trace = reduce(self._stopped.events())
            self._stopped = None
