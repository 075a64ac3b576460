"""The port's spans (`utils/logging.span`) on the CPU.

* With no profiler running, `span` hands back one shared null context.
* A `profile_trace` of a B=2 ADVANCED_TROT `rollout_segment` of 9 ticks
  holds every span of the closed loop, each nested in its layer: the loop,
  the simulator, the control tick and its swing and MPC parts, the MPC
  solve with its build, condensation and QP stages, and the host's wait on
  the solve gate (the WBC's gate runs only with the WBC).
* One solve gate a tick, and one `qtpu.mpc.solve` for each tick whose MPC
  iteration falls on the cadence.
* The rollout's traces are bit-identical with the profiler on and off.
* A trace of user annotations alone records no span.
* A `use_wbc` loop (the Aliengo at H=5, B=2, two segments of WBC_TICKS):
  each tick on which the WBC runs holds `qtpu.ctrl.wbc` inside its
  `qtpu.ctrl`, with `qtpu.wbc.tasks`, `.dynamics` and `.qp` inside it; a
  tick that the WBC's gate skips holds none of them; `qtpu.wbc.model` is
  there once a segment; the counters `wbc_step.calls` and `.skipped` count
  the ticks the WBC ran and the gate skipped, WBC_TICKS * 2 in all; and
  the loop's traces are bit-identical with the profiler on and off.
"""

import contextlib
import json

import pytest
import torch

from quadruped_tpu_torch.control import mpc, swing, wbc
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params, aliengo_params
from quadruped_tpu_torch.sim import rollout
from quadruped_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)

TICKS = 9
# Each span's innermost enclosing span in the closed loop (None: outermost).
PARENT = {
    "qtpu.rollout": None,
    "qtpu.sim.observe": "qtpu.rollout",
    "qtpu.sim.step": "qtpu.rollout",
    "qtpu.ctrl": "qtpu.rollout",
    "qtpu.ctrl.swing": "qtpu.ctrl",
    "qtpu.ctrl.mpc": "qtpu.ctrl",
    "qtpu.sync.solve_gate": "qtpu.ctrl.mpc",
    "qtpu.mpc.solve": "qtpu.ctrl.mpc",
    "qtpu.mpc.build": "qtpu.mpc.solve",
    "qtpu.condense": "qtpu.mpc.build",
    "qtpu.qp.operands": "qtpu.mpc.solve",
    "qtpu.qp.inverse": "qtpu.mpc.solve",
    "qtpu.qp.admm": "qtpu.mpc.solve",
}


WBC_TICKS = 8
WBC_SEGMENTS = 2
# The WBC's spans and their innermost enclosing spans in a `use_wbc` loop.
WBC_PARENT = {
    "qtpu.wbc.model": "qtpu.rollout",
    "qtpu.sync.wbc_gate": "qtpu.ctrl",
    "qtpu.ctrl.wbc": "qtpu.ctrl",
    "qtpu.wbc.tasks": "qtpu.ctrl.wbc",
    "qtpu.wbc.dynamics": "qtpu.ctrl.wbc",
    "qtpu.wbc.qp": "qtpu.ctrl.wbc",
}
WBC_INNER = ("qtpu.wbc.tasks", "qtpu.wbc.dynamics", "qtpu.wbc.qp")


def _loop():
    config = LocomotionConfig(mpc=mpc.MpcConfig(), swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT("cpu"))
    params = a1_params("cpu")
    cmd = TwistCommand.constant(vx=[0.3, 0.5], wz=[0.0, 0.1], device="cpu")
    return config, params, cmd, rollout.rollout_init(config, params, 2)


def _segment(profiled: bool, logdir: str = ""):
    """(carry before, result) of TICKS ticks from a fresh boot, under
    `profile_trace` when `profiled`."""
    config, params, cmd, carry = _loop()
    out = []

    def run():
        out.append(rollout.rollout_segment(config, params, cmd, carry,
                                           TICKS)[1])

    if profiled:
        tlog.profile_trace(run, (), logdir)
    else:
        run()
    return carry, out[0]


def _spans(logdir: str) -> list:
    """(start, end, name) of every `qtpu.` span of a `profile_trace`."""
    with open(f"{logdir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("qtpu.")]


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("spans"))
    carry, result = _segment(True, logdir)
    return carry, result, _spans(logdir)


def _wbc_loop():
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40), swing=swing.SwingConfig(),
        gait=ADVANCED_TROT("cpu"), wbc=wbc.WbcConfig(), use_wbc=True)
    params = aliengo_params("cpu")
    cmd = TwistCommand.constant(vx=[0.2, 0.5], device="cpu")
    return config, params, cmd, rollout.rollout_init(config, params, 2)


def _wbc_segments(profiled: bool, logdir: str = ""):
    """(results of WBC_SEGMENTS segments of WBC_TICKS ticks from a fresh
    boot, the counters' increments over them), under `profile_trace` when
    `profiled`."""
    config, params, cmd, carry = _wbc_loop()
    out = []

    def run():
        c = carry
        for _ in range(WBC_SEGMENTS):
            c, res = rollout.rollout_segment(config, params, cmd, c,
                                             WBC_TICKS)
            out.append(res)

    before = (wbc._STEP.calls, wbc._STEP.skipped)
    if profiled:
        tlog.profile_trace(run, (), logdir)
    else:
        run()
    return out, (wbc._STEP.calls - before[0], wbc._STEP.skipped - before[1])


def _wbc_gate():
    """Per tick of the WBC segments, whether any scenario runs the WBC:
    every 2nd tick of its own count, never on a tick that solves the MPC;
    read from the controller's state before each tick."""
    config, params, cmd, carry = _wbc_loop()
    gate = []
    for _ in range(WBC_SEGMENTS * WBC_TICKS):
        ctrl = carry.ctrl
        gate.append(bool(((ctrl.wbc_iteration % 2 == 0)
                          & ~mpc.solve_mask(config.mpc, ctrl.mpc)).any()))
        carry, _ = rollout.rollout_segment(config, params, cmd, carry, 1)
    return gate


@pytest.fixture(scope="module")
def wbc_profiled(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("wbc_spans"))
    results, counts = _wbc_segments(True, logdir)
    return results, counts, _spans(logdir), _wbc_gate()


def _parents(spans):
    """Each span's innermost enclosing span, by interval (None: none)."""
    out = []
    for s, e, name in spans:
        holders = [(e2 - s2, n2) for s2, e2, n2 in spans
                   if s2 <= s and e <= e2 and (s2, e2, n2) != (s, e, name)]
        out.append((name, min(holders)[1] if holders else None))
    return out


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = tlog.span("qtpu.a"), tlog.span("qtpu.b")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    for name in WBC_PARENT:
        assert tlog.span(name) is a, name


def test_a_trace_of_user_annotations_alone_records_no_span():
    """The spans are operator-scope ranges: a profiler that records only
    user annotations sees none of them, and so mirrors none of them onto
    the device's timeline."""
    from torch._C._profiler import RecordScope
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler, profiler)
    config, params, cmd, carry = _loop()
    prof = profiler.profile(use_kineto=True)
    cfg, acts = prof.config(), prof.kineto_activities
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        with torch.profiler.record_function("outer"):
            rollout.rollout_segment(config, params, cmd, carry, 2)
    finally:
        names = [e.name() for e in _disable_profiler().events()]
    assert names == ["outer"]


def test_closed_loop_spans_nest_by_layer(profiled):
    _, _, spans = profiled
    assert {n for _, _, n in spans} == set(PARENT)
    assert sum(n == "qtpu.rollout" for _, _, n in spans) == 1
    for name, parent in _parents(spans):
        assert parent == PARENT[name], (name, parent)


def test_one_solve_gate_a_tick_and_solves_by_the_cadence(profiled):
    carry, _, spans = profiled
    count = {n: sum(m == n for _, _, m in spans) for n in PARENT}
    cfg = mpc.MpcConfig()
    it0 = carry.ctrl.mpc.iteration.tolist()
    solving = sum(any((i + k) % cfg.ticks_per_solve == 0 for i in it0)
                  for k in range(TICKS))
    assert solving == 2
    assert count["qtpu.sync.solve_gate"] == TICKS
    assert count["qtpu.mpc.solve"] == solving
    for name in ("qtpu.mpc.build", "qtpu.condense", "qtpu.qp.operands",
                 "qtpu.qp.inverse", "qtpu.qp.admm"):
        assert count[name] == solving, name
    for name in ("qtpu.ctrl", "qtpu.ctrl.swing", "qtpu.ctrl.mpc",
                 "qtpu.sim.observe", "qtpu.sim.step"):
        assert count[name] == TICKS, name


def test_traces_are_bit_identical_with_the_profiler_on_and_off(profiled):
    _, on, _ = profiled
    _, off = _segment(False)
    for field in ("alive", "base_height_trace", "vel_trace", "forces_trace",
                  "tau_trace"):
        assert torch.equal(getattr(on, field), getattr(off, field)), field
    for a, b in zip(torch.utils._pytree.tree_leaves(on.sim.__dict__),
                    torch.utils._pytree.tree_leaves(off.sim.__dict__)):
        assert torch.equal(a, b)


def test_the_gate_runs_and_skips_the_wbc(wbc_profiled):
    *_, gate = wbc_profiled
    assert 0 < sum(gate) < len(gate)


def test_wbc_spans_nest_by_layer(wbc_profiled):
    _, _, spans, _ = wbc_profiled
    names = {n for _, _, n in spans}
    assert set(WBC_PARENT) <= names
    assert names - set(WBC_PARENT) <= set(PARENT)
    for name, parent in _parents(spans):
        if name in WBC_PARENT:
            assert parent == WBC_PARENT[name], (name, parent)


def test_wbc_spans_only_on_the_ticks_the_gate_lets_through(wbc_profiled):
    _, _, spans, gate = wbc_profiled
    ticks = sorted((s, e) for s, e, n in spans if n == "qtpu.ctrl")
    assert len(ticks) == len(gate)
    for (s, e), ran in zip(ticks, gate):
        inside = [n for s2, e2, n in spans if s <= s2 and e2 <= e]
        assert inside.count("qtpu.ctrl.wbc") == int(ran)
        for name in WBC_INNER:
            assert inside.count(name) == int(ran), name


def test_wbc_model_once_a_segment(wbc_profiled):
    _, _, spans, _ = wbc_profiled
    count = {n: sum(m == n for _, _, m in spans)
             for n in ("qtpu.rollout", "qtpu.wbc.model")}
    assert count == {"qtpu.rollout": WBC_SEGMENTS,
                     "qtpu.wbc.model": WBC_SEGMENTS}


def test_wbc_counters_count_the_gate(wbc_profiled):
    _, (calls, skipped), spans, gate = wbc_profiled
    assert calls + skipped == WBC_SEGMENTS * WBC_TICKS
    assert calls == sum(gate) == sum(n == "qtpu.ctrl.wbc"
                                      for _, _, n in spans)
    assert skipped == len(gate) - sum(gate)


def test_wbc_traces_are_bit_identical_with_the_profiler_on_and_off(
        wbc_profiled):
    on, counts_on, _, _ = wbc_profiled
    off, counts_off = _wbc_segments(False)
    assert counts_on == counts_off
    for a, b in zip(on, off):
        for field in ("alive", "base_height_trace", "vel_trace",
                      "forces_trace", "tau_trace"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field
