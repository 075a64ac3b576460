"""The port's spans in a traced window: host time by layer, the host's waits
for the device, and device time by the span that launched it.

The port names each layer of its tick with `utils.logging.span` (`qtpu.`
ranges: `qtpu.rollout`, `qtpu.sim.*`, `qtpu.ctrl*`, `qtpu.mpc.*`,
`qtpu.condense`, `qtpu.qp.*`, `qtpu.sync.*`), record functions in the
operators' scope. The harness's light trace (`trace.Tracer`) records only
user annotations, so it does not see them and its numbers are as they were.
`SpanTracer` is that trace with the operators' scope recorded too: each
span is then a host range on the clock of the device's activity, beside
every operator call. `reduce` keeps the spans beside the harness's own
reduction (`trace.reduce`, unchanged) and links each device event to the
start of the runtime call that put it there (a launch, copy or memset), by
the correlation id the profiler gives both.

    python -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and window as `portbench.run --trace 1` does, with the
same traced units under `SpanTracer`, and prints the spans' table, the
readings by layer, the share of device time linked to a launch, the top
device operations by span and the idle gaps named by span; `--span-cost
<n>` times a span with no profiler, under the light trace and under
`SpanTracer`. It needs a CUDA card, as `portbench.run` does. Recording
every operator call costs host time on top of the light trace's (the
printed `trace cost`): the host times are for comparing layers.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import trace as trace_mod

PREFIX = "qtpu."
# Host time a tick of each layer: (spans whose total time counts, spans
# whose self time counts).
HOST_LAYERS = {
    "loop_ms_per_tick": ((), ("qtpu.rollout",)),
    "control_ms_per_tick": ((), ("qtpu.ctrl", "qtpu.ctrl.swing",
                                 "qtpu.ctrl.mpc")),
    "solve_ms_per_tick": (("qtpu.mpc.solve",), ()),
    "sim_ms_per_tick": (("qtpu.sim.observe", "qtpu.sim.step"), ()),
    "sync_ms_per_tick": (("qtpu.sync.solve_gate", "qtpu.sync.wbc_gate"), ()),
}
# Device time an update launched while each span was the innermost.
DEVICE_LAYERS = {
    "inverse_device_ms_per_update": "qtpu.qp.inverse",
    "condense_device_ms_per_update": "qtpu.condense",
    "operands_device_ms_per_update": "qtpu.qp.operands",
}
K1 = "fused_admm_kernel"
# Host calls of the CUDA runtime and driver APIs: the launches, copies and
# memsets that put each device event on the device, among others.
RUNTIME = "cu"


def innermost(spans: list) -> list:
    """Disjoint (start, end, name) pieces of the time the (properly nested)
    `spans` cover, each named by the innermost span over it."""
    pieces, stack, t = [], [], 0.0
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            pieces.append((t, end, inner))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, inner = stack.pop()
        pieces.append((t, end, inner))
        t = end
    return [p for p in pieces if p[1] > p[0]]


@dataclass
class SpanTrace:
    """Times in seconds on the profiler's clock. `base` is the harness's
    own reduction of the same events; `spans` the `qtpu.` host ranges that
    start inside a unit; `device` each device event of the window (kernel,
    copy, memset; no annotation's mirror) as (start, end, name, start of
    its runtime call, a launch, copy or memset, or None)."""

    base: trace_mod.Trace
    spans: list
    device: list

    def __post_init__(self):
        pieces = innermost(self.spans)
        self._starts = [p[0] for p in pieces]
        self._pieces = pieces

    def label(self, t: float | None) -> str | None:
        """The innermost span at host time `t` (None: none)."""
        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._pieces[i][1]:
            return self._pieces[i][2]
        return None

    def count(self, name: str) -> int:
        return sum(n == name for _, _, n in self.spans)

    def total_s(self, name: str) -> float:
        return float(sum(e - s for s, e, n in self.spans if n == name))

    def self_s(self, name: str) -> float:
        """The span's time less the union of its child spans'."""
        return float(sum(e - s for s, e, n in self._pieces if n == name))

    def device_by_span(self) -> dict:
        """{innermost span at the launch (None: none, or no launch found):
        (device seconds, events)}."""
        out: dict = {}
        for s, e, _, launch in self.device:
            key = self.label(launch)
            sec, k = out.get(key, (0.0, 0))
            out[key] = (sec + (e - s), k + 1)
        return out

    def device_ops_by_span(self, top: int = 5) -> dict:
        """{innermost span at the launch: its `top` device operations by
        summed seconds, as [[name, seconds], ...]}."""
        sums: dict = {}
        for s, e, name, launch in self.device:
            ops = sums.setdefault(str(self.label(launch)), {})
            ops[name] = ops.get(name, 0.0) + (e - s)
        return {span: sorted(([k[:120], v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:top]
                for span, ops in sums.items()}

    def launches_by_span(self) -> dict:
        """{innermost span at the call: launch calls of the window}."""
        out: dict = {}
        for t in self.base.launches if self.base.launches is not None \
                else ():
            key = self.label(float(t))
            out[key] = out.get(key, 0) + 1
        return out

    def linked_share(self) -> float | None:
        """Device time whose launch call was found, over all device time."""
        total = sum(e - s for s, e, _, _ in self.device)
        linked = sum(e - s for s, e, _, launch in self.device
                     if launch is not None)
        return linked / total if total > 0 else None

    def kernel_spans(self, contains: str) -> dict:
        """{innermost span at the launch: events} of the device events whose
        name holds `contains`."""
        out: dict = {}
        for _, _, name, launch in self.device:
            if contains in name:
                key = self.label(launch)
                out[key] = out.get(key, 0) + 1
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """The harness's idle gaps (`Trace.idle_gaps`) with the innermost
        span that held the launch of the operation ending each gap put
        first: "<span> before <op>"; "before <op>" where no span held it."""
        plain = dataclasses.replace(
            self.base, device=[d[:3] for d in self.device])
        busy = plain.busy_intervals()
        if len(busy) == 0:
            return [["no device work", plain.window_s]]
        lo, hi = plain.window
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[:, 1] - edges[:, 0]
        firsts = {}
        for s, _, name, launch in sorted(self.device, key=lambda d: d[:3]):
            firsts.setdefault(max(s, lo), (name, launch))
        totals: dict = {}
        for g in np.flatnonzero(gaps > 0):
            if g < len(busy):
                name, launch = firsts[float(edges[g, 1])]
                span = self.label(launch)
                key = ("before " if span is None else f"{span} before ") \
                    + name
            else:
                key = "after the last device work"
            totals[key] = totals.get(key, 0.0) + float(gaps[g])
        return sorted(([k[:200], v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:top]


def reduce(events) -> SpanTrace:
    """A SpanTrace from the profiler's kineto events."""
    events = list(events)
    base = trace_mod.reduce(events)
    spans, device, launch_at = [], [], {}
    for ev in events:
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        kind = trace_mod._kind(ev)
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if kind in trace_mod.DEVICE_KINDS or (
                not kind and on_device
                and not name.startswith(("portbench.", PREFIX))):
            device.append((start, end, name, ev))
        elif on_device:
            continue
        elif name.startswith(PREFIX):
            spans.append((start, end, name))
        elif name.startswith(RUNTIME):
            launch_at[ev.correlation_id()] = start
    lo, hi = base.window
    linked = []
    for s, e, name, ev in device:
        if e <= lo or s >= hi:
            continue
        # The runtime's correlation id, which the call that put the event
        # there shares; the linked id names the enclosing operator, from a
        # count of its own.
        launch = launch_at.get(ev.correlation_id())
        linked.append((s, e, name, launch))
    starts = base.unit_spans[:, 0] if len(base.unit_spans) else []
    ends = base.unit_spans[:, 1] if len(base.unit_spans) else []
    inside = [sp for sp in spans
              if any(a <= sp[0] < b for a, b in zip(starts, ends))]
    return SpanTrace(base=base, spans=inside, device=linked)


def readings(st: SpanTrace | None, work: dict) -> dict:
    """{metric stem: value or None}: host ms a tick by layer in the closed
    loops (`work["ticks_per_unit"]`), device ms an update by span in the
    update (no ticks); None where the spans are absent."""
    out: dict = {}
    if st is None or st.base.units == 0:
        return out
    per_tick = work.get("ticks_per_unit")
    if per_tick:
        ticks = st.base.units * per_tick
        for metric, (totals, selfs) in HOST_LAYERS.items():
            if not any(st.count(n) for n in totals + selfs):
                out[metric] = None
                continue
            sec = sum(st.total_s(n) for n in totals) \
                + sum(st.self_s(n) for n in selfs)
            out[metric] = 1e3 * sec / ticks
        return out
    by_span = st.device_by_span()
    for metric, name in DEVICE_LAYERS.items():
        sec, k = by_span.get(name, (0.0, 0))
        out[metric] = 1e3 * sec / st.base.units if k else None
    return out


def table(st: SpanTrace) -> list:
    """One line a span name: count, host ms a unit (total, self), device ms
    a unit launched while it was the innermost span, launches a unit."""
    units = max(st.base.units, 1)
    dev = st.device_by_span()
    launches = st.launches_by_span()
    names = sorted({n for _, _, n in st.spans}) + [None]
    lines = [f"span table over {st.base.units} units: name, count, host ms "
             f"a unit (total, self), device ms a unit, launches a unit"]
    for name in names:
        host = (f"{st.count(name)}, {1e3 * st.total_s(name) / units}, "
                f"{1e3 * st.self_s(name) / units}" if name else "-, -, -")
        sec, _ = dev.get(name, (0.0, 0))
        lines.append(f"  {name or '(outside any span)'}: {host}, "
                     f"{1e3 * sec / units}, {launches.get(name, 0) / units}")
    return lines


class SpanTracer(trace_mod.Tracer):
    """The harness's tracer recording the operators' scope beside the user
    annotations, and keeping the spans as it reduces the events."""

    spans = None

    def _start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import (_enable_profiler, _prepare_profiler,
                                    profiler)
        from torch.profiler import record_function
        cuda = self.device.type == "cuda"
        prof = profiler.profile(use_device="cuda" if cuda else None,
                                use_kineto=True)
        config, acts = prof.config(), prof.kineto_activities
        self._sync()
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE,
                                        RecordScope.FUNCTION})
        self._t = time.perf_counter()
        self._window = record_function(trace_mod.WINDOW)
        self._window.__enter__()

    def close(self):
        if self._window is not None:
            self._stop()
        if self._stopped is not None:
            self.spans = reduce(self._stopped.events())
            self.trace = self.spans.base
            self._stopped = None


def span_cost(n: int) -> dict:
    """Microseconds a `with span(...)` costs with no profiler, under the
    harness's light trace (which does not record it) and under
    `SpanTracer`; and a `torch.profiler.record_function` with no
    profiler."""
    from quadruped_tpu_torch.utils.logging import span

    def loop(fn):
        t = time.perf_counter()
        for _ in range(n):
            with fn("qtpu.cost"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"n": n, "span_off_us": loop(span),
           "record_function_off_us": loop(torch.profiler.record_function)}
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for key, cls in (("span_light_trace_us", trace_mod.Tracer),
                     ("span_span_trace_us", SpanTracer)):
        tracer = cls(True, 1, device)
        with tracer.unit():
            out[key] = loop(span)
    return out


def run(name: str, seed: int, seconds: float, device,
        overrides: dict | None = None) -> dict:
    """A cell's set-up and traced window (its `trace_units`); returns the
    SpanTrace, the driver's work numbers, the window and the trace cost
    line."""
    from portbench import harness
    files = harness.cell_files(name)
    traffic = dict(files["traffic"], **(overrides or {}))
    driver = files["driver"]
    state = driver.setup(files["config"], traffic, seed, device)
    tracer = SpanTracer(True, traffic["trace_units"], device)
    win = driver.window(state, seconds, tracer)
    tracer.close()
    return {"spans": tracer.spans, "work": driver.work(state, win),
            "window": win, "files": files,
            "trace_cost": harness._trace_cost(tracer, win)}


def summary(r: dict) -> dict:
    """What a run of `run` gives to read: the trace cost line, the window,
    busy time as the harness reduces it and with every annotation's mirror
    left out, the readings by layer, the harness's own per-layer metrics,
    the share of device time linked to its launch, where K1's kernels were
    launched, the units' host ms against the rollout span's, the top device
    operations and the idle gaps by span, and the spans' table."""
    from portbench import harness
    st, work = r["spans"], r["work"]
    base = st.base
    units = max(base.units, 1)
    return {
        "trace_cost": r["trace_cost"], "units": base.units,
        "window_s": base.window_s, "busy_s_harness": base.busy_s(),
        "busy_s": dataclasses.replace(
            base, device=[d[:3] for d in st.device]).busy_s(),
        "readings": readings(st, work),
        "existing": {m["name"]: harness.reader(m["name"])(base, work)
                     for m in r["files"]["per_layer"]},
        "linked_share": st.linked_share(),
        "k1_spans": {str(k): v for k, v in st.kernel_spans(K1).items()},
        "unit_host_ms": 1e3 * float(np.sum(base.unit_spans[:, 1]
                                           - base.unit_spans[:, 0])) / units,
        "rollout_ms": 1e3 * st.total_s("qtpu.rollout") / units,
        "device_ops_by_span": st.device_ops_by_span(),
        "idle_gaps": st.idle_gaps(), "table": table(st)}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from portbench import harness
    from portbench.run import _environment

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--span-cost", type=int, default=0)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    _environment()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    report = {"card": harness.card_line(device)}
    if a.span_cost:
        report["span_cost"] = span_cost(a.span_cost)
    if a.workload:
        report.update(workload=a.workload, seed=a.seed,
                      **summary(run(a.workload, a.seed, a.seconds, device)))
    lines = report.pop("table", [])
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(report), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(report, table=lines), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
