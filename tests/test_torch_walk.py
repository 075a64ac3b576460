"""The walk gait and one walk tick of the port against the JAX package (CPU).

* Walk gait: `walk_gait_update` over three 10 s cycles of WALK() (3000
  ticks of 10 ms) at B=8 with staggered start times and four contact
  streams (the detected-stance feedback of tests/test_walk_gait.py, all
  feet down, none down, a random stream), against one jitted JAX scan:
  sub-states and detected states equal (CPU: equal); full-cycle phases
  and move_base_phase within GAIT_TOL = 1e-6 (CPU 1.2e-7 and 7.2e-7); the
  phase within the sub-state within 2e-6 (CPU 1.5e-6: two float32 steps of
  the full-cycle phase scaled by 1 / ((1 - duty) * 0.2) = 20 in a
  0.2-wide sub-state; the port forms the swing phase as JAX's walk tick
  does, from the exact product, see gait/walk.py) and the load ratios,
  10x that phase, within 2e-5 (CPU 1.5e-5). Then the JAX checks of
  tests/test_walk_gait.py on the port's run.
* `walk_step`: one tick at B=8 from random states (ticks around the
  swing-window and TRUE_SWING entries, a replan in half the scenarios) in
  four settings: the SRB sim on flat ground, the SRB sim on a 0.1 rad
  slope with `terrain_height` and `ground_rpy`, the whole-body sim at the
  8 cm step with `foot_stepper.stair_foothold_adjust` as the foothold hook,
  and the whole-body sim on the slope. Every command field, the forces and
  every WalkState field against the JAX package's tick, kept in
  tests/data/walk_step_a1.npz (the flat SRB setting is also run live in
  JAX): integer fields equal, the rest within STEP_TOL (the forces 0.5 N:
  the force QP's kappa ~ 1e8 moves float32 minimizers of two
  implementations by up to ~0.33 N, tests/test_torch_force_balance.py;
  CPU readings in STEP_TOL's comments).

Regenerate the fixture (only when the JAX reference changes on purpose):
    PYTHONPATH=. python tests/test_torch_walk.py
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import walk as bench_walk
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.walk_locomotion import WalkState, walk_step
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait import WALK, LegState
from quadruped_tpu_torch.gait import walk as walk_mod
from quadruped_tpu_torch.gait.walk import SubLegState
from quadruped_tpu_torch.robots import a1_params, kinematics
from quadruped_tpu_torch.sim import srb_sim, terrain
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils.convert import as_numpy, flatten, to_torch

# Small batches: one intra-op thread a process. torch would otherwise
# spread each op over every core, and the tier-1 run's six workers
# would oversubscribe the CPU (a whole-body test file: 55 s with the
# default threads alone, 35 s with one).
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "walk_step_a1.npz"
GAIT_TOL = 1e-6
SUB_PHASE_TOL = 2e-6
RATIO_TOL = 2e-5
GAIT_TICKS, GAIT_DT, GAIT_B = 3000, 0.01, 8
STEP_B = 8
SLOPE = 0.1
# walk_step port vs JAX, CPU readings in the comments.
STEP_TOL = {"forces": 0.5,            # 0.067 N
            "tau": 0.2,               # 0.022 N m
            "q": 1e-5,                # 1.2e-6 rad
            "pose": 1e-6,             # < 1e-7 (the SQP's target pose)
            "other": 5e-6}            # 4.8e-7 (normalized phase)
SETTINGS = ("srb_flat", "srb_slope", "wb_stair", "wb_slope")


# --- walk gait ---

def _gait_inputs():
    rng = np.random.default_rng(0)
    t0 = rng.uniform(0.0, 10.0, GAIT_B).astype(np.float32)
    ts = (np.arange(1, GAIT_TICKS + 1, dtype=np.float32)[:, None]
          * np.float32(GAIT_DT) + t0).astype(np.float32)       # [T, B]
    mode = np.arange(GAIT_B) % 4                  # feedback/ones/zeros/random
    rand = (rng.random((GAIT_TICKS, GAIT_B, 4)) < 0.7).astype(np.float32)
    return ts, mode, rand


def _contact(mode, rand_k, detected_stance):
    return np.where((mode == 0)[:, None], detected_stance,
                    np.where((mode == 1)[:, None], 1.0,
                             np.where((mode == 2)[:, None], 0.0, rand_k)))


@functools.lru_cache(maxsize=None)
def _jax_gait():
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.gait import WALK as JWALK
    from quadruped_tpu.gait import walk as jw

    ts, mode, rand = _gait_inputs()
    config = JWALK()

    def one(t_b, mode_b, rand_b):
        def step(state, x):
            t, r = x
            det = (state.detected_leg_state == LegState.STANCE).astype(
                jnp.float32)
            contact = jnp.where(mode_b == 0, det, jnp.where(
                mode_b == 1, 1.0, jnp.where(mode_b == 2, 0.0, r)))
            new = jw.walk_gait_update(config, state, t, contact)
            f_min, f_max = jw.load_ratios(new)
            return new, (new, f_min, f_max)

        return jax.lax.scan(step, jw.walk_gait_init(config),
                            (t_b, rand_b))[1]

    states, f_min, f_max = jax.jit(jax.vmap(one, in_axes=(1, 0, 1)))(
        ts, mode, rand)
    out = as_numpy(states)
    out["f_min"], out["f_max"] = np.asarray(f_min), np.asarray(f_max)
    return out


@functools.lru_cache(maxsize=None)
def _port_gait():
    ts, mode, rand = _gait_inputs()
    config = WALK("cpu")
    state = walk_mod.walk_gait_init(config, GAIT_B)
    keys = ("leg_sub_state", "detected_leg_state", "normalized_phase",
            "phase_in_full_cycle", "move_base_phase", "f_min", "f_max")
    out = {k: [] for k in keys}
    for k in range(GAIT_TICKS):
        det = (state.detected_leg_state == LegState.STANCE).float().numpy()
        contact = torch.as_tensor(_contact(mode, rand[k], det),
                                  dtype=torch.float32)
        state = walk_mod.walk_gait_update(config, state,
                                          torch.as_tensor(ts[k]), contact)
        f_min, f_max = walk_mod.load_ratios(state)
        values = dict(as_numpy(state), f_min=f_min.numpy(),
                      f_max=f_max.numpy())
        for key in keys:
            out[key].append(values[key])
    return {k: np.stack(v, 1) for k, v in out.items()}


def test_walk_gait_matches_jax():
    got, want = _port_gait(), _jax_gait()
    for key in ("leg_sub_state", "detected_leg_state"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("phase_in_full_cycle", "move_base_phase"):
        assert np.abs(got[key] - want[key]).max() <= GAIT_TOL, key
    for key in ("f_min", "f_max"):
        assert np.abs(got[key] - want[key]).max() <= RATIO_TOL, key
    assert np.abs(got["normalized_phase"]
                  - want["normalized_phase"]).max() <= SUB_PHASE_TOL
    for key in ("true_swing_start", "true_swing_end"):
        np.testing.assert_allclose(
            walk_mod.walk_gait_init(WALK("cpu"), 1).__dict__[key].numpy(),
            want[key][:1, 0], atol=GAIT_TOL)


def test_substate_sequence():
    """Each leg cycles STANCE -> FULL_STANCE -> UNLOAD -> TRUE_SWING ->
    LOAD -> STANCE."""
    order = [LegState.STANCE, SubLegState.FULL_STANCE,
             SubLegState.UNLOAD_FORCE, SubLegState.TRUE_SWING,
             SubLegState.LOAD_FORCE]
    subs = _port_gait()["leg_sub_state"]
    for b in range(GAIT_B):
        for leg in range(4):
            seq = subs[b, :, leg]
            s = list(seq[np.concatenate([[True], seq[1:] != seq[:-1]])])
            assert any(s[i:i + 5] == order for i in range(len(s) - 4)), s


def test_one_leg_swings_at_a_time():
    swinging = _port_gait()["leg_sub_state"] == SubLegState.TRUE_SWING
    assert swinging.sum(axis=-1).max() <= 1
    assert swinging.any(axis=1).all()


def test_stance_fraction_matches_duty():
    frac = np.mean(_port_gait()["leg_sub_state"] == LegState.STANCE, axis=1)
    np.testing.assert_allclose(frac, 0.75, atol=0.04)


def test_move_base_phase_range():
    mbp = _port_gait()["move_base_phase"]
    assert mbp.min() >= 0.0 and mbp.max() <= 1.0


def test_early_and_lose_contact_detection():
    det = _port_gait()["detected_leg_state"]
    mode = _gait_inputs()[1]
    assert (det[mode == 1] == LegState.EARLY_CONTACT).any()
    assert (det[mode == 2] == LegState.LOSE_CONTACT).any()


def _gait_state(sub, detected, phi):
    state = walk_mod.walk_gait_init(WALK("cpu"), 1)
    return dataclasses.replace(
        state, leg_sub_state=torch.as_tensor([sub], dtype=torch.int32),
        detected_leg_state=torch.as_tensor([detected], dtype=torch.int32),
        normalized_phase=torch.as_tensor([phi], dtype=torch.float32))


def test_load_ratios_ramp():
    stance = LegState.STANCE
    f_min, f_max = walk_mod.load_ratios(_gait_state(
        [SubLegState.UNLOAD_FORCE, stance, SubLegState.TRUE_SWING,
         SubLegState.LOAD_FORCE], [stance] * 4, [0.5, 0.2, 0.5, 0.25]))
    np.testing.assert_allclose(f_max[0].numpy(), [5.0, 10.0, 0.001, 2.5],
                               atol=1e-5)
    assert f_min[0, 1] > 0


def test_early_contact_overrides_load_ratio():
    stance = LegState.STANCE
    f_min, f_max = walk_mod.load_ratios(_gait_state(
        [SubLegState.TRUE_SWING, stance, stance, stance],
        [LegState.EARLY_CONTACT, stance, stance, stance],
        [0.5, 0.1, 0.1, 0.1]))
    assert abs(f_max[0, 0].item() - 0.1) < 1e-6
    assert abs(f_min[0, 0].item() - 0.001) < 1e-6
    assert f_max[0, 1].item() == 10.0


# --- one walk tick ---

def _step_inputs(setting: str):
    """Random states (numpy) for one walk tick of `setting`: the sim state,
    the controller's WalkState and the tick times."""
    rng = np.random.default_rng(SETTINGS.index(setting))
    b = STEP_B
    f32 = np.float32
    # Ticks at the TRUE_SWING entries and swing-window entries of the 3.7 s
    # table (308, 617, 925, ...), their neighbours, and random ones.
    ticks = np.asarray([308, 616, 925, 0, 309, 1233, 2000, 0]) \
        + np.asarray([0, 0, 0, 0, 0, 0, 0, rng.integers(2, 2400)])
    t = (ticks + 1).astype(f32) * f32(bench_walk.DT)
    t_prev = ticks.astype(f32) * f32(bench_walk.DT)
    config = bench_walk.walk_table("cpu")
    prev = walk_mod.walk_gait_update(
        config, walk_mod.walk_gait_init(config, b), torch.as_tensor(t_prev),
        torch.ones(b, 4))
    slope = SLOPE if setting.endswith("slope") else 0.0
    rpy = np.stack([rng.normal(0, 0.02, b), -slope + rng.normal(0, 0.02, b),
                    rng.normal(0, 0.05, b)], -1).astype(f32)
    quat = se3.rpy_to_quat(torch.as_tensor(rpy)).numpy()
    x = rng.normal(0.0, 0.02, b)
    if setting == "wb_stair":
        x = x + bench_walk.RISER_X - 0.12
    pos = np.stack([x, rng.normal(0, 0.01, b),
                    0.27 + np.tan(slope) * x + rng.normal(0, 0.005, b)],
                   -1).astype(f32)
    params = a1_params("cpu")
    q = (params.stand_angles.numpy()[None]
         + rng.normal(0, 0.03, (b, 12))).astype(f32)
    vel = rng.normal(0, 0.05, (b, 3)).astype(f32)
    omega = rng.normal(0, 0.1, (b, 3)).astype(f32)
    dq = rng.normal(0, 0.3, (b, 12)).astype(f32)
    feet_base = kinematics.foot_positions_in_base_frame(
        params, torch.as_tensor(q)).numpy()
    r = se3.quat_to_rotmat(torch.as_tensor(quat)).numpy()
    feet = np.einsum("bij,blj->bli", r, feet_base) + pos[:, None]
    if setting.startswith("srb"):
        anchors = feet.copy()
        sim = {"position": pos, "quat": quat, "vel_world": vel,
               "omega_world": omega, "q": q, "dq": dq,
               "foot_anchor": anchors.astype(f32),
               "t": t_prev.astype(f32)}
    else:
        sim = {"fb": {"quat": quat, "position": pos, "omega_body": omega,
                      "vel_body": vel, "q": q, "dq": dq},
               "t": t_prev.astype(f32)}
    pose_start = np.concatenate([pos, rpy], -1) \
        + rng.normal(0, 0.01, (b, 6)).astype(f32)
    walk = {
        "gait": as_numpy(prev),
        "pose": {"pose_start": pose_start.astype(f32),
                 "pose_target": (pose_start + rng.normal(0, 0.02, (b, 6))
                                 ).astype(f32),
                 "planned": (np.arange(b) % 2).astype(f32)},
        "command": {
            "position": np.tile([0.0, 0.0, 0.27], (b, 1)).astype(f32),
            "rpy": np.zeros((b, 3), f32),
            "velocity": np.zeros((b, 3), f32),
            "omega": np.zeros((b, 3), f32),
            "filtered_linear": np.stack(
                [rng.uniform(0, 0.05, b), np.zeros(b), np.zeros(b)],
                -1).astype(f32),
            "filtered_wz": np.zeros(b, f32)},
        "liftoff_pos_world": (feet + rng.normal(0, 0.005, feet.shape)
                              ).astype(f32),
        "foot_target_world": (feet + rng.normal(0, 0.02, feet.shape)
                              ).astype(f32),
        "prev_sub_state": prev.leg_sub_state.numpy(),
        "warm_forces": np.zeros((b, 4, 3), f32),
    }
    vx = rng.uniform(0.02, 0.07, b).astype(f32)
    return sim, walk, t, vx


def _terrain(setting: str, jax_side: bool):
    if jax_side:
        from quadruped_tpu.sim import terrain as ter
    else:
        ter = terrain
    if setting.endswith("slope"):
        return ter.slope(pitch=SLOPE)
    if setting == "wb_stair":
        return ter.stairs(step_length=5.0, step_height=bench_walk.STEP_HEIGHT,
                          start_x=bench_walk.RISER_X - 5.0)
    return None


def _jax_step(setting: str):
    """The JAX package's tick on _step_inputs(setting): a flat dict."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as jfb
    from quadruped_tpu.control import walk_locomotion as jwl
    from quadruped_tpu.control.desired_state import TwistCommand as JTC
    from quadruped_tpu.dynamics import floating_base as jfbm
    from quadruped_tpu.gait.scheduler import _config
    from quadruped_tpu.planner import foot_stepper as jfs
    from quadruped_tpu.robots import a1_params as ja1
    from quadruped_tpu.sim import srb_sim as jsrb
    from quadruped_tpu.sim import whole_body as jwb

    sim, walk, t, vx = _step_inputs(setting)
    params = ja1()
    config = jwl.WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=jfb.ForceBalanceConfig(
            kp=jnp.asarray(bench_walk.KP), kd=jnp.asarray(bench_walk.KD),
            qp_iters=40))
    terr = _terrain(setting, True)
    ground = (jnp.asarray([0.0, -SLOPE, 0.0], jnp.float32)
              if setting.endswith("slope") else None)
    hook = None
    if setting == "wb_stair":
        stair = jfs.StairParams(
            start_x=jnp.asarray(bench_walk.RISER_X), width=jnp.asarray(5.0),
            height=jnp.asarray(bench_walk.STEP_HEIGHT), count=jnp.asarray(1))

        def hook(target, feet):
            x_adj, _ = jfs.stair_foothold_adjust(feet[:, 0], stair, 0.1)
            return target.at[:, 0].set(x_adj)

    def one(sim_d, walk_d, t_b, v):
        if setting.startswith("srb"):
            sim_s = jsrb.SrbSimState(**sim_d)
            sup = (walk_d["gait"]["leg_sub_state"]
                   != SubLegState.TRUE_SWING).astype(jnp.float32)
            obs = jsrb.observe(params, sim_s, sup)
        else:
            sim_s = jwb.WholeBodySimState(fb=jfbm.FbState(**sim_d["fb"]),
                                          t=sim_d["t"])
            obs = jwb.observe(params, jfbm.build_model(params), sim_s,
                              jwb.ContactModel(), terrain_height=terr)
        from quadruped_tpu.control.desired_state import DesiredStateCommand
        from quadruped_tpu.gait.walk import WalkGaitState
        from quadruped_tpu.planner.pose_planner import PosePlannerState

        st = jwl.WalkState(
            gait=WalkGaitState(**walk_d["gait"]),
            pose=PosePlannerState(**walk_d["pose"]),
            command=DesiredStateCommand(**walk_d["command"]),
            liftoff_pos_world=walk_d["liftoff_pos_world"],
            foot_target_world=walk_d["foot_target_world"],
            prev_sub_state=walk_d["prev_sub_state"],
            warm_forces=walk_d["warm_forces"])
        cmd = JTC.constant(vx=v, body_height=0.27)
        command, forces, new = jwl.walk_step(
            config, params, st, obs, cmd, t_b, terrain_height=terr,
            ground_rpy=ground, foothold_adjust_fn=hook)
        return {"command": {f.name: getattr(command, f.name)
                            for f in dataclasses.fields(command)},
                "forces": forces, "state": new}

    out = jax.jit(jax.vmap(one))(sim, walk, t, vx)
    out = jax.tree.map(np.asarray, out)
    flat = flatten({"command": out["command"], "forces": out["forces"],
                    "state": as_numpy(out["state"])}, setting)
    return flat


def _port_step(setting: str):
    sim, walk, t, vx = _step_inputs(setting)
    device = "cpu"
    params = a1_params(device)
    config = bench_walk.walk_config(bench_walk.walk_table(device))
    terr = _terrain(setting, False)
    ground = (torch.as_tensor([0.0, -SLOPE, 0.0])
              if setting.endswith("slope") else None)
    hook = bench_walk.stair_hook(device) if setting == "wb_stair" else None
    state = to_torch(walk, WalkState, device=device)
    if setting.startswith("srb"):
        sim_s = to_torch(sim, srb_sim.SrbSimState, device=device)
        obs = srb_sim.observe(params, sim_s, bench_walk.support_mask(state))
    else:
        sim_s = to_torch(sim, wb.WholeBodySimState, device=device)
        obs = wb.observe(params, fb.build_model(params), sim_s,
                         wb.ContactModel(), terrain_height=terr)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27, device=device)
    command, forces, new = walk_step(config, params, state, obs, cmd,
                                     torch.as_tensor(t), terrain_height=terr,
                                     ground_rpy=ground,
                                     foothold_adjust_fn=hook)
    return flatten({"command": as_numpy(command), "forces": forces.numpy(),
                    "state": as_numpy(new)}, setting)


def _tol(key: str) -> float:
    if key.endswith("/forces") or key.endswith("warm_forces"):
        return STEP_TOL["forces"]
    if key.endswith("command/tau"):
        return STEP_TOL["tau"]
    if key.endswith("command/q"):
        return STEP_TOL["q"]
    if "/pose/" in key:
        return STEP_TOL["pose"]
    return STEP_TOL["other"]


def _assert_step_close(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for key, ref in want.items():
        value = got[key]
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(value, ref, err_msg=key)
        else:
            err = np.abs(value - ref).max()
            assert err <= _tol(key), f"{key}: {err} > {_tol(key)}"


@pytest.mark.parametrize("setting", SETTINGS)
def test_walk_step_matches_jax_fixture(setting):
    data = np.load(FIXTURE)
    want = {k: data[k] for k in data.files if k.startswith(setting + "/")}
    _assert_step_close(_port_step(setting), want)


def test_walk_step_fixture_is_jax():
    """JAX still computes the flat SRB setting's fixture."""
    data = np.load(FIXTURE)
    got = _jax_step("srb_flat")
    for key, value in got.items():
        np.testing.assert_array_equal(value, data[key], err_msg=key)


def test_walk_step_inputs_cover_the_events():
    """The random states hold a TRUE_SWING entry, a swing-window entry
    (replan) and both planned and unplanned pose states."""
    out = _port_step("srb_flat")
    sub = out["srb_flat/state/gait/leg_sub_state"]
    prev = _step_inputs("srb_flat")[1]["prev_sub_state"]
    assert ((sub == SubLegState.TRUE_SWING)
            & (prev != SubLegState.TRUE_SWING)).any()
    assert ((sub == SubLegState.FULL_STANCE)
            & (prev == LegState.STANCE)).any()


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    arrays = {}
    for s in SETTINGS:
        arrays.update(_jax_step(s))
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print("wrote", FIXTURE, FIXTURE.stat().st_size, "bytes")
    for s in SETTINGS:
        got, want = _port_step(s), {k: arrays[k] for k in arrays
                                    if k.startswith(s + "/")}
        print(s, {k.split("/", 1)[1]: float(np.abs(got[k] - want[k]).max())
                  for k in want if want[k].dtype.kind == "f"
                  and np.abs(got[k] - want[k]).max() > 1e-7})
