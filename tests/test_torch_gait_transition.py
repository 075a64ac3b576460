"""Online gait transitions and the WALK mode of `locomotion_step` against
the JAX package (CPU).

* The transition manager alone (the JAX tests/test_gait_transition.py
  sequence and round trip): TROT -> BOUND at B=4 with requests at
  different ticks per scenario (one, two, one late, none), 700 ticks of 10
  ms through `gait_transition_step`, `gait_update` and `hold_stance_gait`,
  against one jitted JAX scan: phases, active tables and the gait states'
  integer fields equal, the command scale and the float fields within
  1e-6. Then the JAX test's checks on the port.
* A batch on different gait tables at the same tick: `gait_update` and
  `predicted_contact_table` under `active_gait` (scenarios on TROT, WALK
  and BOUND) against jax.vmap with one table per scenario.
* The closed loop: the first three segments of the JAX
  test_closed_loop_trot_walk_trot (400 + 400 + 1000 ticks of
  `rollout_segment`, ADVANCED_TROT, `MpcConfig(horizon=5, qp_iters=24,
  qp_cold_iters=120)`, `gait_b` the 0.45 s walk table, vx = 0.25) at B=4,
  scenarios 0-1 raising `gait_switch` in segment 2 and 2-3 not, against
  the JAX package's run kept in tests/data/gait_transition_a1.npz: the
  transition phase and active table of every tick equal; heights,
  velocities and the state at each segment's end within
  test_torch_rollout.py's limits, forces within 1% m*g, until the swap to
  the walk table; after it (a tie that XLA's fused multiply-add breaks
  otherwise starts each walk swing one tick apart,
  benchmarks/transition.py) within AFTER_SWAP; then the JAX test's own
  checks on the port.
* WALK through `locomotion_step` (the force-balance stance with the WALK()
  table, VELOCITY-mode swing): `rollout` at B=4 for 150 ticks against the
  same fixture, with test_torch_locomotion_modes.py's limits.

The limits are benchmarks/transition.py's TOL and AFTER_SWAP (CPU
readings beside AFTER_SWAP; before the swap the loop reads at most 2.6e-5
m, 1.5e-4 m/s and 0.51 N of force).

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_gait_transition.py
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from card_device import DEVICES, on
from quadruped_tpu_torch.control import gait_transition as gt
from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import ControlMode, TwistCommand
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.control.stance_force_balance import \
    ForceBalanceConfig
from quadruped_tpu_torch.gait import (BOUND, TROT, WALK, gait_init,
                                      gait_update, predicted_contact_table,
                                      stance_contact_mask)
from quadruped_tpu_torch.benchmarks import transition
from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import rollout as rollout_mod

# Small batches: one intra-op thread a process. torch would otherwise
# spread each op over every core, and the tier-1 run's six workers
# would oversubscribe the CPU (a whole-body test file: 55 s with the
# default threads alone, 35 s with one).
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "gait_transition_a1.npz"
UNIT_TICKS, UNIT_DT = 700, 0.01
# Request ticks per scenario (-1: none).
REQUESTS = np.asarray([[10, -1], [10, 350], [120, -1], [-1, -1]])
UNIT_TOL = 1e-6
SEGMENTS = (400, 400, 1000)
SWITCH = np.asarray([[0, 1, 0], [0, 1, 0], [0, 0, 0], [0, 0, 0]],
                    np.float32)          # [B, segment] gait_switch level
VX = 0.25
WALK_TICKS = 150
WALK_VX = [0.0, 0.02, 0.04, 0.06]
TRACE_STRIDE = transition.TRACE_STRIDE
MG = transition.MG
TOL = transition.TOL
SIM_FIELDS = transition.SIM_FIELDS


# --- the transition manager alone ---

def _unit_port():
    b = len(REQUESTS)
    a, bnd = TROT("cpu"), BOUND("cpu")
    ts = gt.gait_transition_init(b, "cpu")
    gs = gait_init(a, b)
    cmd = TwistCommand.constant(vx=np.asarray([0.4, 0.3, 0.4, 0.3],
                                              np.float32), device="cpu")
    out = {"phase": [], "active_idx": [], "scale": [], "stance": [],
           "leg_state": [], "phase_in_full_cycle": [], "reset_time": []}
    for i in range(UNIT_TICKS):
        t = torch.full((b,), float(np.float32(i + 1) * np.float32(UNIT_DT)))
        req = torch.as_tensor((REQUESTS == i).any(1))
        ts = gt.GaitTransitionState(**{
            f.name: torch.where(req, getattr(gt.request_transition(ts, t),
                                             f.name), getattr(ts, f.name))
            for f in dataclasses.fields(ts)})
        active, gs, cmd_out, hold, ts = gt.gait_transition_step(
            ts, gs, a, bnd, cmd, t)
        gs = gait_update(active, gs, t, stance_contact_mask(gs))
        gs = gt.hold_stance_gait(hold, gs)
        for key, value in (("phase", ts.phase), ("active_idx", ts.active_idx),
                           ("scale", cmd_out.linear[:, 0]),
                           ("stance", active.stance_duration[:, 0]),
                           ("leg_state", gs.leg_state),
                           ("phase_in_full_cycle", gs.phase_in_full_cycle),
                           ("reset_time", gs.reset_time)):
            out[key].append(value.numpy())
    return {k: np.stack(v, 1) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _unit_jax():
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import gait_transition as jgt
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.gait import BOUND as JB, TROT as JT
    from quadruped_tpu.gait import gait_init as jinit, gait_update as jupd
    from quadruped_tpu.gait import stance_contact_mask as jmask

    a, bnd = JT(), JB()

    def one(req, vx):
        cmd = JTC.constant(vx=vx)

        def step(carry, i):
            ts, gs = carry
            t = (i + 1).astype(jnp.float32) * UNIT_DT
            ts = jax.tree.map(lambda x, y: jnp.where(jnp.any(req == i), x, y),
                              jgt.request_transition(ts, t), ts)
            active, gs, cmd_out, hold, ts = jgt.gait_transition_step(
                ts, gs, a, bnd, cmd, t)
            gs = jupd(active, gs, t, jmask(gs))
            gs = jgt.hold_stance_gait(hold, gs)
            return (ts, gs), {"phase": ts.phase, "active_idx": ts.active_idx,
                              "scale": cmd_out.linear[0],
                              "stance": active.stance_duration[0],
                              "leg_state": gs.leg_state,
                              "phase_in_full_cycle": gs.phase_in_full_cycle,
                              "reset_time": gs.reset_time}

        return jax.lax.scan(step, (jgt.gait_transition_init(), jinit(a)),
                            jnp.arange(UNIT_TICKS))[1]

    out = jax.jit(jax.vmap(one))(jnp.asarray(REQUESTS),
                                 jnp.asarray([0.4, 0.3, 0.4, 0.3]))
    return {k: np.asarray(v) for k, v in out.items()}


def test_transition_manager_matches_jax():
    got, want = _unit_port(), _unit_jax()
    for key in ("phase", "leg_state"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("active_idx", "scale", "stance", "phase_in_full_cycle",
                "reset_time"):
        assert np.abs(got[key] - want[key]).max() <= UNIT_TOL, key


def test_transition_sequence():
    """Scenario 0 (one request at tick 10): NONE -> DECEL -> STAND -> NONE,
    the command ramps to zero through the hold and returns, the table goes
    TROT (0.3 s stance) -> BOUND (0.25 s)."""
    run = _unit_port()
    phases, scales, stance = run["phase"][0, :320], run["scale"][0, :320], \
        run["stance"][0, :320]
    assert phases[5] == gt.TransitionPhase.NONE
    assert (phases == gt.TransitionPhase.DECEL).any()
    stand = np.nonzero(phases == gt.TransitionPhase.STAND)[0]
    assert stand.size and phases[-1] == gt.TransitionPhase.NONE
    np.testing.assert_allclose(scales[0], 0.4, atol=1e-6)
    np.testing.assert_allclose(scales[stand[0]], 0.0, atol=1e-6)
    np.testing.assert_allclose(scales[-1], 0.4, atol=1e-6)
    np.testing.assert_allclose(stance[0], 0.3, atol=1e-6)
    assert abs(stance[-1] - 0.25) < 1e-6
    assert run["active_idx"][0, 319] == 1.0


def test_transition_round_trip_toggles():
    """Scenario 1 (requests at ticks 10 and 350) is back on TROT."""
    run = _unit_port()
    assert run["phase"][1, -1] == gt.TransitionPhase.NONE
    assert run["active_idx"][1, -1] == 0.0
    np.testing.assert_allclose(run["stance"][1, -1], 0.3, atol=1e-6)
    # No request: never leaves NONE.
    assert (run["phase"][3] == gt.TransitionPhase.NONE).all()


def test_mixed_tables_match_jax():
    """Scenarios on TROT, WALK and BOUND at the same tick."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.gait import BOUND as JB, TROT as JT, WALK as JW
    from quadruped_tpu.gait import gait_init as jinit, gait_update as jupd
    from quadruped_tpu.gait import predicted_contact_table as jtable

    tables = [TROT("cpu"), WALK("cpu"), BOUND("cpu"), WALK("cpu")]
    j_tables = [JT(), JW(), JB(), JW()]
    b = len(tables)
    mixed = type(tables[0])(**{
        f.name: torch.stack([getattr(c, f.name) for c in tables])
        for f in dataclasses.fields(tables[0])})
    j_mixed = jax.tree.map(lambda *x: jnp.stack(x), *j_tables)
    rng = np.random.default_rng(3)
    contact = (rng.random((60, b, 4)) < 0.8).astype(np.float32)

    def j_one(cfg, c):
        def step(gs, x):
            t, ck = x
            gs = jupd(cfg, gs, t, ck)
            return gs, (gs.leg_state, gs.normalized_phase,
                        jtable(cfg, gs, 0.025, 5))
        ts = jnp.arange(1, 61, dtype=jnp.float32) * 0.02
        return jax.lax.scan(step, jinit(cfg), (ts, c))[1]

    want = [np.asarray(x) for x in jax.jit(jax.vmap(j_one, in_axes=(0, 1)))(
        j_mixed, contact)]
    gs = gait_init(mixed, b)
    got = [[], [], []]
    for k in range(60):
        t = torch.full((b,), float(np.float32(k + 1) * np.float32(0.02)))
        gs = gait_update(mixed, gs, t, torch.as_tensor(contact[k]))
        for out, value in zip(got, (gs.leg_state, gs.normalized_phase,
                                    predicted_contact_table(mixed, gs, 0.025,
                                                            5))):
            out.append(value.numpy())
    got = [np.stack(v, 1) for v in got]
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= UNIT_TOL
    np.testing.assert_array_equal(got[2], want[2])


# --- the closed loop ---

transition_config = transition.config


def _summary(res, to_numpy, stride=TRACE_STRIDE):
    out = {f: to_numpy(getattr(res.sim, f)) for f in SIM_FIELDS}
    out["base_height_trace"] = to_numpy(res.base_height_trace)
    out["vel_trace"] = to_numpy(res.vel_trace)
    out["forces_trace"] = to_numpy(res.forces_trace)
    out["alive"] = to_numpy(res.alive)
    return out


@functools.lru_cache(maxsize=None)
def _port_loop(device="cpu"):
    config, params = transition_config(device), a1_params(device)
    b = len(SWITCH)
    carry = rollout_mod.rollout_init(config, params, b)
    segs, trans = [], {"phase": [], "active_idx": []}
    for s, steps in enumerate(SEGMENTS):
        cmd = TwistCommand.constant(vx=VX, gait_switch=SWITCH[:, s],
                                    batch=b, device=device)
        for _ in range(steps):
            carry, res = rollout_mod.rollout_segment(config, params, cmd,
                                                     carry, 1)
            trans["phase"].append(carry.ctrl.transition.phase.cpu().numpy())
            trans["active_idx"].append(
                carry.ctrl.transition.active_idx.cpu().numpy())
            segs.append(_summary(res, lambda x: x.cpu().numpy()))
    return segs, {k: np.stack(v, 1) for k, v in trans.items()}


def _loop_view(segs, trans):
    """The part of the closed loop the fixture keeps."""
    ends = np.cumsum(SEGMENTS) - 1
    out = {"loop/phase": trans["phase"].astype(np.int8),
           "loop/active_idx": trans["active_idx"].astype(np.int8)}
    for key in ("base_height_trace", "vel_trace", "forces_trace"):
        series = np.concatenate([s[key] for s in segs], axis=1)
        out[f"loop/{key}"] = series[:, TRACE_STRIDE - 1::TRACE_STRIDE]
    for s, end in enumerate(ends):
        for f in SIM_FIELDS + ("alive",):
            out[f"loop/end{s}/{f}"] = segs[end][f]
        out[f"loop/end{s}/forces"] = segs[end]["forces_trace"][:, -1]
    return out


def _walk_mode_config(device=None) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=30),
        swing=swing_mod.SwingConfig(mode=ControlMode.WALK),
        gait=WALK(device), mode=ControlMode.WALK,
        force_balance=ForceBalanceConfig())


@functools.lru_cache(maxsize=None)
def _port_walk_mode():
    res = rollout_mod.rollout(
        _walk_mode_config("cpu"), a1_params("cpu"),
        TwistCommand.constant(vx=np.asarray(WALK_VX, np.float32),
                              body_height=0.27, device="cpu"), WALK_TICKS)
    run = _summary(res, lambda x: x.numpy())
    return {f"walk_mode/{k}": v for k, v in run.items()}


def _hold(got, want, keys):
    for key in keys:
        assert np.all(np.isfinite(got[key])), key
        tol = TOL[key.rsplit("/", 1)[-1]]
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= tol, f"{key}: {err} > {tol}"


@pytest.mark.parametrize("device", DEVICES)
def test_closed_loop_matches_jax(device):
    errors = transition.fixture_errors(_loop_view(*_port_loop(on(device))),
                                       np.load(FIXTURE))
    for key, (err, limit) in errors.items():
        assert err <= limit, f"{key}: {err} > {limit}"


def test_closed_loop_trot_walk_trot_checks():
    """The JAX test's checks on the port's three segments."""
    segs, trans = _port_loop()
    ends = np.cumsum(SEGMENTS) - 1
    switching = SWITCH[:, 1] > 0.5
    for end in ends:
        assert (segs[end]["alive"] == 1.0).all()
    assert (trans["phase"][:, ends[0]] == gt.TransitionPhase.NONE).all()
    # Segment 2: the switching scenarios decelerate, then stand with every
    # leg loaded.
    assert np.isin(trans["phase"][switching, ends[1]],
                   (gt.TransitionPhase.DECEL, gt.TransitionPhase.STAND)).all()
    assert (segs[ends[1]]["forces_trace"][switching, -1, :, 2] > 1.0).all()
    # Segment 3: walking on the second table, at most two legs unloaded
    # over the last 300 ticks; the others keep trotting.
    assert (trans["phase"][:, ends[2]] == gt.TransitionPhase.NONE).all()
    np.testing.assert_array_equal(trans["active_idx"][:, ends[2]],
                                  switching.astype(np.float32))
    fz = np.stack([s["forces_trace"][:, -1, :, 2]
                   for s in segs[ends[2] - 299:ends[2] + 1]], 1)
    assert (4 - (fz[switching] > 0.5).sum(-1)).max() <= 2


def test_walk_mode_matches_jax():
    data = np.load(FIXTURE)
    got = _port_walk_mode()
    np.testing.assert_array_equal(got["walk_mode/alive"],
                                  data["walk_mode/alive"])
    keys = [f"walk_mode/{f}" for f in SIM_FIELDS]
    _hold(got, data, keys)
    for key in ("base_height_trace", "vel_trace"):
        _hold({key: got[f"walk_mode/{key}"][:, TRACE_STRIDE - 1::
                                             TRACE_STRIDE]},
              {key: data[f"walk_mode/{key}"]}, [key])
    assert (got["walk_mode/alive"] == 1.0).all()
    # Forces on the ticks where neither package's polish missed its
    # minimizer (as test_torch_locomotion_modes.py; CPU: each misses on 2 of
    # the 120 kept ticks), within 2% m*g: with one WALK() leg swinging the
    # kappa ~ 1e8 QP's float32 minimizers of the two packages lie up to
    # 1.84 N apart on the CPU (the TROT modes: 1% m*g).
    forces = got["walk_mode/forces_trace"][:, TRACE_STRIDE - 1::
                                           TRACE_STRIDE]
    want = data["walk_mode/forces_trace"]
    missed_port, missed_jax = bench_walk.missed(forces), \
        bench_walk.missed(want)
    assert missed_port.sum() <= missed_jax.sum() + 2, missed_port.sum()
    held = ~(missed_port | missed_jax)
    err = np.abs(forces - want).max((-1, -2))[held].max()
    assert err <= 0.02 * MG, err


def _jax_fixture() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as jm
    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control import swing as js
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.control.locomotion import LocomotionConfig as JLC
    from quadruped_tpu.gait import ADVANCED_TROT as JAT, WALK as JW
    from quadruped_tpu.gait.scheduler import _config as jconfig
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim.rollout import (rollout, rollout_init,
                                           rollout_segment)

    params = ja1()
    config = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
                 swing=js.SwingConfig(), gait=JAT(),
                 gait_b=jconfig(0.45, 0.75, [0.5, 0.0, 0.75, 0.25]))
    assert SEGMENTS == transition.SEGMENTS[:transition.FIXTURE_SEGMENTS]

    def seg(carry, sw, steps):
        def one(c, s):
            # One tick at a time, so the transition state of every tick is
            # kept.
            def tick(c, _):
                c, res = rollout_segment(
                    config, params, JTC.constant(vx=VX, gait_switch=s), c, 1,
                    0.002)
                return c, (res, c.ctrl.transition)
            return jax.lax.scan(tick, c, None, length=steps)
        return jax.vmap(one)(carry, sw)

    seg = jax.jit(seg, static_argnums=2)
    carry = jax.vmap(lambda _: rollout_init(config, params))(
        jnp.arange(len(SWITCH)))
    segs, trans = [], {"phase": [], "active_idx": []}
    for s, steps in enumerate(SEGMENTS):
        carry, (res, tr) = seg(carry, jnp.asarray(SWITCH[:, s]), steps)
        trans["phase"].append(np.asarray(tr.phase))
        trans["active_idx"].append(np.asarray(tr.active_idx))
        for k in range(steps):
            segs.append(_summary(jax.tree.map(lambda x: x[:, k], res),
                                 np.asarray))
    trans = {k: np.concatenate(v, 1) for k, v in trans.items()}
    out = _loop_view(segs, trans)

    wcfg = JLC(mpc=jm.MpcConfig(horizon=5, qp_iters=30),
               swing=js.SwingConfig(mode=ControlMode.WALK), gait=JW(),
               mode=ControlMode.WALK, force_balance=jfb.ForceBalanceConfig())
    res = jax.jit(jax.vmap(lambda v: rollout(wcfg, params, JTC.constant(
        vx=v, body_height=0.27), steps=WALK_TICKS)))(
            jnp.asarray(WALK_VX, jnp.float32))
    run = _summary(res, np.asarray)
    for key, value in run.items():
        if key in ("base_height_trace", "vel_trace", "forces_trace"):
            value = value[:, TRACE_STRIDE - 1::TRACE_STRIDE]
        out[f"walk_mode/{key}"] = value
    return out


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    arrays = _jax_fixture()
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
    got = dict(_loop_view(*_port_loop()), **_port_walk_mode())
    for key, value in arrays.items():
        if value.dtype.kind == "f" and key in got:
            g = got[key]
            if key.startswith("walk_mode/") and g.shape != value.shape:
                g = g[:, TRACE_STRIDE - 1::TRACE_STRIDE]
            print(key, float(np.max(np.abs(g - value))))
        elif key in got:
            print(key, "equal" if np.array_equal(got[key], value)
                  else "DIFFERS")
