"""The SRB sim step as a CUDA graph (quadruped_tpu_torch/sim/srb_sim.py).

* On CPU: CPU tensors run the eager step and count as eager only, also
  with a wrapper set on the module's `srb_sim_step` (as the stage counter
  of benchmarks/tick_ops.py sets one, which then runs); the cached gravity
  and side-sign constants equal the tensors the step and the kinematics
  made on every call before, per (dtype, device), and a second call hands
  back the same object; `signed_hip_length` reads the cached sign.
* On the card (marker `cuda`): closed loops of 120 ticks (15 MPC solves)
  at B=2048 and B=1 and a stacked fleet of four robots, each with the
  graphed step bit for bit equal to the eager one in every trace and
  carry field; outputs that later calls leave unchanged; a capture for
  each new batch or new parameters, and the counters; the eager fallbacks;
  calls made on a stream of the caller's own.
  This module imports no JAX, so the card tests also run where JAX is
  absent:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \
          tests/test_torch_sim_graph.py
"""

import pytest
import torch

from card_device import cuda_device  # noqa: F401
from quadruped_tpu_torch.benchmarks import fleet
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params, params as params_mod
from quadruped_tpu_torch.robots import stack_params
from quadruped_tpu_torch.robots.params import SIDE_SIGN, per_scenario
from quadruped_tpu_torch.sim import rollout, srb_sim
from quadruped_tpu_torch.utils import tree

STEP = srb_sim.srb_sim_step
DT = 0.002


def _counts() -> tuple:
    return STEP.eager, STEP.captures, STEP.replays


def _delta(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_counts(), before))


def _inputs(params, batch: int, device, seed: int) -> tuple:
    """A state off the stand pose with random forces, stance and swing
    targets, drawn on the CPU and moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    state = srb_sim.srb_sim_init(params, batch)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(device)

    state = srb_sim.SrbSimState(
        position=state.position + rnd(batch, 3, scale=0.01),
        quat=state.quat + rnd(batch, 4, scale=0.02),
        vel_world=rnd(batch, 3, scale=0.3),
        omega_world=rnd(batch, 3, scale=0.3),
        q=state.q + rnd(batch, 12, scale=0.05),
        dq=rnd(batch, 12, scale=0.5),
        foot_anchor=state.foot_anchor + rnd(batch, 4, 3, scale=0.01),
        t=state.t + 0.1)
    forces = rnd(batch, 4, 3, scale=5.0) + torch.tensor(
        [0.0, 0.0, 30.0], device=device)
    stance = (torch.rand(batch, 4, generator=g) > 0.4).float().to(device)
    q_des = params.stand_angles.expand(batch, 12) + rnd(batch, 12, scale=0.1)
    dq_des = rnd(batch, 12, scale=0.2)
    swing = 1.0 - torch.repeat_interleave(stance, 3, dim=-1)
    return state, forces, stance, q_des, dq_des, swing


def _leaves_equal(a, b) -> list:
    """The paths of the tensor leaves of a and b that differ in any bit."""
    return [pa for (pa, xa), (_, xb) in zip(tree.leaves(a), tree.leaves(b))
            if isinstance(xa, torch.Tensor) and not torch.equal(xa, xb)]


def test_cpu_tensors_take_the_eager_step():
    params = a1_params("cpu")
    args = _inputs(params, 3, "cpu", 0)
    before = _counts()
    out = [STEP(params, *args, DT) for _ in range(3)]
    assert _delta(before) == (3, 0, 0)
    assert all(key[0].type == "cuda" for key in srb_sim._GRAPHS)
    eager = srb_sim._step(params, *args, DT, 3.0)
    for o in out:
        assert _leaves_equal(o, eager) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_constants_equal_the_per_call_tensors(dtype):
    cpu = torch.device("cpu")
    g = srb_sim.gravity(dtype, cpu)
    assert g.dtype == dtype and g.device == cpu
    assert torch.equal(g, torch.tensor([0.0, 0.0, -9.81], dtype=dtype))
    assert srb_sim.gravity(dtype, cpu) is g
    s = params_mod.side_sign(dtype, cpu)
    assert s.dtype == dtype and s.device == cpu
    assert torch.equal(s, torch.as_tensor(SIDE_SIGN, dtype=dtype))
    assert params_mod.side_sign(dtype, cpu) is s


@pytest.mark.parametrize("robots", [("a1",), ("a1", "go1", "aliengo")])
def test_signed_hip_length_reads_the_cached_sign(robots):
    """One robot ([4]) or a stacked fleet ([B, 4]): the cached sign times
    the abad length, equal to the sign made per call."""
    p = (a1_params("cpu") if len(robots) == 1
         else stack_params(robots, "cpu"))
    want = per_scenario(p, p.hip_length, 2) * torch.as_tensor(
        SIDE_SIGN, dtype=torch.float32)
    got = p.signed_hip_length
    assert got.shape == want.shape and torch.equal(got, want)


def test_a_wrapped_step_still_counts(monkeypatch):
    """A wrapper set on `srb_sim.srb_sim_step` (tick_ops's stage counter
    sets one) runs the step, which counts on the function it was defined
    as."""
    params = a1_params("cpu")
    args = _inputs(params, 2, "cpu", 1)
    calls = []

    def wrapped(*a, _fn=srb_sim.srb_sim_step, **kw):
        calls.append(1)
        return _fn(*a, **kw)

    monkeypatch.setattr(srb_sim, "srb_sim_step", wrapped)
    before = _counts()
    out = srb_sim.srb_sim_step(params, *args, DT)
    assert calls == [1] and _delta(before) == (1, 0, 0)
    assert _leaves_equal(out, srb_sim._step(params, *args, DT, 3.0)) == []


def test_tick_ops_counts_the_sim_stage():
    """benchmarks/tick_ops.py wraps every stage function, the step among
    them, and counts the step's operator calls under `srb_sim`."""
    from quadruped_tpu_torch.benchmarks import tick_ops
    before = _counts()
    out = tick_ops.count("velocity", 2, 1, torch.device("cpu"))
    assert out["other_calls_by_stage"]["srb_sim"] > 0
    assert _delta(before) == (4, 0, 0)      # 3 warm ticks and the counted
    assert srb_sim.srb_sim_step is STEP


def _eager_step(params, state, forces, stance, q_des, dq_des, swing, dt,
                stance_kd=3.0):
    return srb_sim._step(params, state, forces, stance, q_des, dq_des, swing,
                         dt, stance_kd)


def _both_ways(monkeypatch, cfg, params, cmd, carry, ticks):
    """rollout_segment from the same carry with the eager step, then with
    the graphed one: (eager (carry, result), graphed (carry, result),
    counter deltas of the graphed run)."""
    start = tree.map_tensors(torch.clone, carry)
    with monkeypatch.context() as m:
        m.setattr(srb_sim, "srb_sim_step", _eager_step)
        eager = rollout.rollout_segment(cfg, params, cmd, start, ticks)
    before = _counts()
    graphed = rollout.rollout_segment(
        cfg, params, cmd, tree.map_tensors(torch.clone, carry), ticks)
    torch.cuda.synchronize()
    return eager, graphed, _delta(before)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2048, 1])
def test_graphed_closed_loop_is_bit_identical(cuda_device, monkeypatch,
                                              batch):
    """120 ticks of the A1 trot at MpcConfig() (a solve every 8 ticks),
    vx U(0.2, 0.8), wz N(0, 0.2): every trace and carry field equal."""
    g = torch.Generator().manual_seed(batch)
    cfg = LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                           swing=swing_mod.SwingConfig(),
                           gait=ADVANCED_TROT(cuda_device))
    params = a1_params(cuda_device)
    cmd = TwistCommand.constant(
        vx=(0.2 + 0.6 * torch.rand(batch, generator=g)).numpy(),
        wz=(0.2 * torch.randn(batch, generator=g)).numpy(),
        batch=batch, device=cuda_device)
    carry = rollout.rollout_init(cfg, params, batch)
    eager, graphed, delta = _both_ways(monkeypatch, cfg, params, cmd, carry,
                                       120)
    assert delta == (1, 1, 118)
    assert _leaves_equal(graphed, eager) == []
    assert float(graphed[1].alive.min()) == 1.0


@pytest.mark.cuda
def test_graphed_fleet_is_bit_identical(cuda_device, monkeypatch):
    """The four robots x four speeds of the fleet benchmark (B=16, stacked
    parameters, per-row force caps) over 40 ticks."""
    f = fleet.build(1, cuda_device)
    assert f.params.stacked
    carry = rollout.rollout_init(f.config, f.params, f.cmd.linear.shape[0])
    eager, graphed, delta = _both_ways(monkeypatch, f.config, f.params,
                                       f.cmd, carry, 40)
    assert delta == (1, 1, 38)
    assert _leaves_equal(graphed, eager) == []


@pytest.mark.cuda
def test_outputs_are_the_callers_own(cuda_device):
    """A returned state is left as it was by later calls (the capture and
    the replays write only the graph's buffers), and each call's state is
    the eager step's of its inputs."""
    params = a1_params(cuda_device)
    kept = []
    for seed in range(5):
        args = _inputs(params, 64, cuda_device, seed)
        out = STEP(params, *args, DT)
        kept.append((out, tree.map_tensors(torch.clone, out),
                     _eager_step(params, *args, DT)))
    torch.cuda.synchronize()
    for out, copy, eager in kept:
        assert _leaves_equal(out, copy) == []
        assert _leaves_equal(out, eager) == []


@pytest.mark.cuda
def test_new_batch_or_params_captures_anew(cuda_device):
    """One capture per key (batch, parameters), replays after; an old key
    replays again without a new capture."""
    p1, p2 = a1_params(cuda_device), a1_params(cuda_device)
    for params, batch, want in ((p1, 32, (1, 1, 2)), (p1, 48, (1, 1, 2)),
                                (p2, 32, (1, 1, 2)), (p1, 32, (0, 0, 4))):
        args = _inputs(params, batch, cuda_device, batch)
        before = _counts()
        for _ in range(4):
            out = STEP(params, *args, DT)
        assert _delta(before) == want, (batch, params is p1)
        assert _leaves_equal(out, _eager_step(params, *args, DT)) == []


@pytest.mark.cuda
def test_eager_fallbacks_on_the_card(cuda_device):
    """A tensor dt, or inputs that need grad under grad mode, run eager;
    the same inputs under no_grad take the graph."""
    params = a1_params(cuda_device)
    args = _inputs(params, 24, cuda_device, 7)
    before = _counts()
    STEP(params, *args, torch.tensor(DT, device=cuda_device))
    forces = args[1].clone().requires_grad_(True)
    out = STEP(params, args[0], forces, *args[2:], DT)
    assert out.position.requires_grad
    assert _delta(before) == (2, 0, 0)
    with torch.no_grad():
        for _ in range(3):
            STEP(params, args[0], forces, *args[2:], DT)
    assert _delta(before) == (3, 1, 1)


@pytest.mark.cuda
def test_cached_constants_on_the_card(cuda_device):
    g = srb_sim.gravity(torch.float32, cuda_device)
    assert g.device == cuda_device and srb_sim.gravity(
        torch.float32, cuda_device) is g
    assert torch.equal(g.cpu(), torch.tensor([0.0, 0.0, -9.81]))
    s = params_mod.side_sign(torch.float32, cuda_device)
    assert s.device == cuda_device and params_mod.side_sign(
        torch.float32, cuda_device) is s
    assert torch.equal(s.cpu(), torch.as_tensor(SIDE_SIGN))


@pytest.mark.cuda
def test_steps_on_the_callers_stream(cuda_device):
    """Warm-up, capture and replays made while the caller has a stream of
    its own current: each state the eager step's, read on that stream."""
    params = a1_params(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    before = _counts()
    with torch.cuda.stream(stream):
        for seed in range(4):
            args = _inputs(params, 40, cuda_device, 100 + seed)
            out = STEP(params, *args, DT)
            assert _leaves_equal(out, _eager_step(params, *args, DT)) == []
    stream.synchronize()
    assert _delta(before) == (1, 1, 2)
