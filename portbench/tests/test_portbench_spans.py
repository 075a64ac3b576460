"""CPU checks of the spans' reduction (`portbench/spans.py`) on a synthetic
event list, with the harness's own reduction and readers beside it, and
the spans' readings of each cell rehearsed on the CPU."""

import json

import pytest
import torch

from portbench import harness, program, spans, trace
from portbench.tests import cases

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
MS = 1e-3
COPY = "Memcpy HtoD (Pageable -> Device)"
T0 = 1.76e9          # the profiler's epoch clock, in seconds


def near(seconds):
    """Equal within 1 us: a float64 second on the epoch clock resolves
    0.24 us."""
    return pytest.approx(seconds, abs=1e-6)


class Ev:
    """The parts of a kineto event that the reductions read."""

    def __init__(self, name, start_ms, end_ms, kind, cuda=False, corr=0,
                 linked=0):
        self._name, self._kind, self._cuda, self._corr = name, kind, cuda, \
            corr
        self._linked = linked
        self._start = int(round((T0 + start_ms * MS) * 1e9))
        self._dur = int(round((end_ms - start_ms) * MS * 1e9))

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def activity_type(self):
        return self._kind

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def _launch(at, corr):
    return Ev("cudaLaunchKernel", at, at + 0.01, "cuda_runtime", corr=corr)


def _kernel(name, s, e, corr):
    # The linked id is the enclosing operator's, from a count of its own
    # that may equal another launch's correlation id.
    return Ev(name, s, e, "kernel", cuda=True, corr=corr, linked=corr % 5 + 1)


# One unit of a window: the loop's span holding the sim step and the control
# tick, whose MPC part holds the solve gate; kernels launched in each, one
# kernel whose launch the trace lost.
HARNESS = [Ev("portbench.window", 0, 100, "user_annotation"),
           Ev("portbench.unit", 1, 99, "user_annotation"),
           Ev("portbench.unit", 1, 99, "gpu_user_annotation", cuda=True)]
KERNELS = [_launch(5, 1), _kernel("add", 6, 7, 1),
           _launch(12, 2), _kernel("mul", 20, 28, 2),
           Ev("cudaMemcpyAsync", 14, 14.01, "cuda_runtime", corr=6),
           Ev(COPY, 17, 18, "gpu_memcpy", cuda=True, corr=6, linked=2),
           _launch(55, 3), _kernel("gemm", 56, 58, 3),
           _launch(66, 5), _kernel("fused_admm_kernel", 67, 69, 5),
           _launch(85, 4), _kernel("add", 86, 87, 4),
           _kernel("orphan", 95, 96, 99)]
SPANS = [Ev("qtpu.rollout", 2, 90, "cpu_op"),
         Ev("qtpu.sim.step", 10, 30, "cpu_op"),
         Ev("qtpu.ctrl", 40, 80, "cpu_op"),
         Ev("qtpu.ctrl.mpc", 50, 70, "cpu_op"),
         Ev("qtpu.sync.solve_gate", 60, 65, "cpu_op")]


def _mirrors(kind):
    """Device mirrors of the spans, as the profiler would add them were the
    spans user annotations (`kind` "" where the profiler gives no kinds)."""
    return [Ev("qtpu.rollout", 6, 87, kind, cuda=True),
            Ev("qtpu.sim.step", 20, 28, kind, cuda=True),
            Ev("qtpu.ctrl.mpc", 56, 69, kind, cuda=True)]


def _events(kind="gpu_user_annotation"):
    return HARNESS + KERNELS + SPANS + _mirrors(kind)


def test_reduce_keeps_the_port_spans():
    st = spans.reduce(_events())
    assert sorted(n for _, _, n in st.spans) == sorted(
        e.name() for e in SPANS)
    assert st.count("qtpu.ctrl") == 1
    assert st.total_s("qtpu.rollout") == near(88 * MS)


@pytest.mark.parametrize("kind", ["gpu_user_annotation", ""])
def test_annotation_mirrors_add_no_busy_time(kind):
    st = spans.reduce(_events(kind))
    assert [d[2] for d in st.device] == [e.name() for e in KERNELS
                                         if e._cuda]
    busy = sum(e._dur for e in KERNELS if e._cuda) * 1e-9
    guarded = trace.Trace(window=st.base.window, units=1,
                          unit_spans=st.base.unit_spans,
                          device=[d[:3] for d in st.device])
    assert guarded.busy_s() == near(busy)
    if kind:
        assert st.base.busy_s() == near(busy)


def test_linked_device_time_lands_in_the_innermost_span():
    st = spans.reduce(_events())
    by = {k: v[0] for k, v in st.device_by_span().items()}
    assert by == near({"qtpu.rollout": 2 * MS, "qtpu.sim.step": 9 * MS,
                       "qtpu.ctrl.mpc": 4 * MS, None: 1 * MS})
    assert st.linked_share() == pytest.approx(15.0 / 16.0, abs=1e-3)
    assert st.kernel_spans("fused_admm_kernel") == {"qtpu.ctrl.mpc": 1}
    assert st.launches_by_span() == {"qtpu.rollout": 2, "qtpu.sim.step": 1,
                                     "qtpu.ctrl.mpc": 2}
    ops = st.device_ops_by_span()
    assert [k for k, _ in ops["qtpu.ctrl.mpc"]] == ["gemm",
                                                   "fused_admm_kernel"]
    assert [k for k, _ in ops["None"]] == ["orphan"]


def test_self_time_leaves_out_the_children():
    st = spans.reduce(_events())
    assert st.self_s("qtpu.rollout") == near((88 - 20 - 40) * MS)
    assert st.self_s("qtpu.ctrl") == near(20 * MS)
    assert st.self_s("qtpu.ctrl.mpc") == near(15 * MS)
    assert st.self_s("qtpu.sync.solve_gate") == near(5 * MS)
    got = spans.readings(st, {"ticks_per_unit": 2})
    # ms a tick over two ticks: 1 us of the clock is 0.5e-3 ms a tick.
    assert got == pytest.approx({
        "loop_ms_per_tick": 14.0, "control_ms_per_tick": 17.5,
        "sim_ms_per_tick": 10.0, "sync_ms_per_tick": 2.5,
        "solve_ms_per_tick": None}, abs=1e-3)


def test_idle_gaps_put_the_span_first():
    st = spans.reduce(_events())
    gaps = dict(st.idle_gaps())
    assert set(gaps) == {"qtpu.rollout before add",
                         "qtpu.sim.step before " + COPY,
                         "qtpu.sim.step before mul",
                         "qtpu.ctrl.mpc before gemm",
                         "qtpu.ctrl.mpc before fused_admm_kernel",
                         "before orphan", "after the last device work"}
    assert gaps["qtpu.sim.step before " + COPY] == near(10 * MS)
    assert gaps["qtpu.sim.step before mul"] == near(2 * MS)
    assert sum(gaps.values()) == near(st.base.window_s - st.base.busy_s())
    for key, value in st.base.idle_gaps():
        # The harness's gap before each operation, split by span.
        assert value == near(sum(v for k, v in gaps.items()
                                 if k == key or k.endswith(" " + key))), key


def test_the_harness_metrics_read_the_same_with_spans():
    work = {"ticks_per_unit": 2, "admm_shape": (8, 120, 24)}
    before = trace.reduce(HARNESS + KERNELS)
    after = trace.reduce(_events())
    for metric in ("device_idle_pct.sweep", "launches_per_tick.sweep",
                   "k1_roofline_pct.update"):
        read = harness.reader(metric)
        assert read(after, work) == read(before, work), metric


def _span_overrides(name: str) -> dict:
    """The rehearsal's sizes, with a tick cell tracing one tick more than
    its configuration's ticks a solve, so that a solve lies inside the
    traced ticks."""
    overrides = cases.small(name)
    if cases.driver(name) == "tick":
        config, _ = program.locomotion(harness.cell_files(name)["config"],
                                       "cpu")
        overrides["trace_units"] = config.mpc.ticks_per_solve + 1
    return overrides


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_reads_the_spans_of_its_cell(name):
    overrides = _span_overrides(name)
    r = spans.run(name, 2 ** 31 + 11, 0.3, torch.device("cpu"), overrides)
    st, work = r["spans"], r["work"]
    got = spans.readings(st, work)
    if "ticks_per_unit" in work:
        assert set(got) == set(spans.HOST_LAYERS)
        assert all(v is not None and v > 0 for v in got.values()), got
        unit_s = float((st.base.unit_spans[:, 1]
                        - st.base.unit_spans[:, 0]).sum())
        ticks = st.base.units * work["ticks_per_unit"]
        assert 0.9 * unit_s < 1e-3 * ticks * sum(got.values()) <= unit_s
    else:
        # No device events on the CPU: the device readings are absent, and
        # each stage's span is there once an update.
        assert set(got) == set(spans.DEVICE_LAYERS)
        assert all(v is None for v in got.values())
        for span in ("qtpu.condense", "qtpu.qp.operands", "qtpu.qp.inverse",
                     "qtpu.qp.admm"):
            assert st.count(span) == st.base.units, span
    out = json.loads(json.dumps(spans.summary(r)))
    assert out["table"][0].startswith("span table")
    assert out["busy_s"] == out["busy_s_harness"] == 0.0
