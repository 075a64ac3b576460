"""The full robot stack on the whole-body sim: sensors -> estimators -> FSM
stand-up -> advanced trot on estimates, on one card.

    python quadruped_tpu_torch/benchmarks/runner.py [--batch 1024]
        [--steps 200] [--start boot|switch]

The twin of the JAX package's examples/example_whole_body_standup.py and
tests/test_estimator_in_loop.py: B A1 robots boot sitting on the floor
(body height 0.15 m, the sit-down joint angles), and `runner_step` (the
estimation container, the FSM's 3 s STAND_UP ramp into LOCOMOTION, the
advanced-trot MPC at `MpcConfig(horizon=5, qp_iters=24,
qp_cold_iters=120)` with its solves on the `fused_admm` kernel) drives the
18-DoF whole-body sim from raw sensors: the true quaternion and foot
forces, the IMU acceleration (the true velocity's finite difference plus
gravity), gyro and joint encoders, with Gaussian noise of standard
deviations NOISE_SIGMA times each scenario's noise level, drawn from an
explicit `torch.Generator` (or given, as the tests give the JAX run's).
`--start switch` resumes from the checkpoint of tests/data/runner_a1.npz
100 ticks before the STAND_UP -> LOCOMOTION switch, tiled to the batch.
One tick is 2 ms of robot time. Prints one JSON line: ms per tick,
ticks/s and robot-seconds per wall second, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.fsm import FsmState
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.estimation.container import (EstimatorConfig,
                                                      RawSensors)
from quadruped_tpu_torch.estimation.velocity import VelocityEstimatorConfig
from quadruped_tpu_torch.exec.runner import (RunnerConfig, RunnerState,
                                             runner_init, runner_step)
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils import card, tree
from quadruped_tpu_torch.utils.convert import to_torch, unflatten

DT = 0.002
# The IMU's finite difference divides by DT; XLA compiles the JAX twin's
# division into a product with the float32 reciprocal, and so does this.
_INV_DT = float(np.float32(1.0) / np.float32(DT))
SIT_HEIGHT = 0.15
ALIVE_HEIGHT = 0.15
# Standard deviations of the sensor noise at level 1: IMU acceleration
# (3), gyro (3), joint angles (12), joint velocities (12).
NOISE_SIGMA = (0.3,) * 3 + (0.02,) * 3 + (0.002,) * 12 + (0.05,) * 12
NOISE_DIM = len(NOISE_SIGMA)
STEPS = 200

FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "data"
           / "runner_a1.npz")
# The fixture's JAX run: B=4, forward speeds and noise levels per row, the
# numpy seed of its noise, and the checkpoints {name: (start tick, window
# ticks)}: in the boot, 100 ticks before the STAND_UP -> LOCOMOTION switch
# (tick 1500), and in the estimated trot. The trot window ends before its
# tick 141, where JAX run again from a state one float32 step off flips an
# estimated contact flag: past it, the flags are not JAX's to keep.
FIXTURE_VX = (0.2, 0.2, 0.25, 0.3)
FIXTURE_NOISE = (0.0, 1.0, 0.0, 1.0)
FIXTURE_SEED = 8
CHECKPOINTS = {"boot": (100, 150), "switch": (1400, 200),
               "trot": (2000, 120)}
FIXTURE_TICKS = max(s + w for s, w in CHECKPOINTS.values())
# Port vs JAX over a window: at most FACTOR x JAX's own spread (the most
# the window moves when JAX runs it again from a state one float32 step
# off in one coordinate), at least FLOOR.
FACTOR = 10.0
FLOOR = {"position": 1e-5, "p_est": 1e-5, "v_est": 1e-4, "q_cmd": 1e-3}


class Loop(NamedTuple):
    """The closed loop's fixed parts and its state."""

    config: RunnerConfig
    params: RobotParams
    model: fb.FloatingBaseModel
    contact: wb.ContactModel
    cmd: TwistCommand
    sim: wb.WholeBodySimState
    runner: RunnerState
    prev_v: torch.Tensor           # [B, 3] last tick's true world velocity
    noise: torch.Tensor            # [B] noise level
    generator: torch.Generator | None
    step: int = 0                  # ticks done


def default_config(device, skip_idle_locomotion: bool = True
                   ) -> RunnerConfig:
    return RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
            swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(device)),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=True, skip_idle_locomotion=skip_idle_locomotion)


def _per_scenario(value, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32),
                           device=device).expand(batch).clone()


def build(batch: int, device=None, noise=1.0, vx=0.2, seed: int = 0,
          config: RunnerConfig | None = None) -> Loop:
    """B A1 robots sitting on flat ground (base at 0.15 m, sit-down joint
    angles), the runner booted from their true state (the MPC cold start
    runs here); on the card unless `device` says otherwise. noise and vx:
    numbers or [B] arrays."""
    device = card.resolve(device)
    params = a1_params(device)
    model = fb.build_model(params)
    contact = wb.ContactModel()
    config = default_config(device) if config is None else config
    sim = wb.whole_body_init(params, batch, body_height=SIT_HEIGHT)
    sim.fb.q[:] = params.sitdown_angles
    runner = runner_init(config, params, wb.observe(params, model, sim,
                                                    contact))
    cmd = TwistCommand.constant(vx=np.asarray(vx, np.float32),
                                body_height=0.27, batch=batch, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Loop(config, params, model, contact, cmd, sim, runner,
                torch.zeros(batch, 3, device=device),
                _per_scenario(noise, batch, device), gen)


def sensors(loop: Loop, sim: wb.WholeBodySimState, n: torch.Tensor):
    """(RawSensors, true observation) of `sim`; n: [B, 30] standard
    normals, scaled by NOISE_SIGMA and the scenarios' noise levels."""
    truth = wb.observe(loop.params, loop.model, sim, loop.contact)
    r = se3.quat_to_rotmat(truth.base_quat)
    acc_world = (truth.base_vel_world - loop.prev_v) * _INV_DT \
        + torch.as_tensor([0.0, 0.0, 9.81], device=r.device)
    level = loop.noise[:, None]

    def noisy(x, lo, hi):
        return x + (level * NOISE_SIGMA[lo]) * n[:, lo:hi]

    raw = RawSensors(
        quat=truth.base_quat,
        acc_body=noisy(torch.einsum("bj,bji->bi", acc_world, r), 0, 3),
        omega_body=noisy(truth.base_omega_body, 3, 6),
        joint_angles=noisy(truth.joint_angles, 6, 18),
        joint_velocities=noisy(truth.joint_velocities, 18, 30),
        foot_forces=truth.foot_forces)
    return raw, truth


TRACE_KEYS = ("position", "fsm", "contact", "v_est", "v_true", "p_est",
              "q_cmd")


def run(loop: Loop, steps: int, noise: torch.Tensor | None = None,
        record: bool = False):
    """Advance the loop by `steps` ticks. noise: [steps, B, 30] standard
    normals (default: drawn from the loop's generator). Returns (loop,
    traces): with `record`, {key of TRACE_KEYS: [B, T, ...]} (the base
    position after the tick, the FSM state, the estimated contact flags,
    the estimated and true world velocity, the estimated position and the
    joint-angle command), else {}."""
    sim, runner, prev_v = loop.sim, loop.runner, loop.prev_v
    b, device = prev_v.shape[0], prev_v.device
    rows: dict = {k: [] for k in TRACE_KEYS} if record else {}
    for k in range(steps):
        n = (torch.randn(b, NOISE_DIM, generator=loop.generator,
                         device=device) if noise is None else noise[k])
        raw, truth = sensors(loop._replace(prev_v=prev_v), sim, n)
        command, _, runner, est = runner_step(loop.config, loop.params,
                                              runner, loop.cmd, sensors=raw)
        sim, _ = wb.whole_body_step(loop.params, loop.model, sim, command,
                                    loop.contact, DT)
        prev_v = truth.base_vel_world
        if record:
            for key, value in (
                    ("position", sim.fb.position), ("fsm", runner.fsm.state),
                    ("contact", runner.estimator.contact.is_contact),
                    ("v_est", est.base_vel_world),
                    ("v_true", truth.base_vel_world),
                    ("p_est", est.base_position), ("q_cmd", command.q)):
                rows[key].append(value)
    traces = {k: torch.stack(v, 1) for k, v in rows.items()}
    return loop._replace(sim=sim, runner=runner, prev_v=prev_v,
                         step=loop.step + steps), traces


def alive(loop: Loop) -> torch.Tensor:
    """[B] 1.0 where the base stands above 0.15 m."""
    return (loop.sim.fb.position[:, 2] > ALIVE_HEIGHT).float()


# --- the ground-truth path on the SRB sim ----------------------------------

def srb_boot(config: RunnerConfig, params: RobotParams, batch: int):
    """(SRB sim, runner state) of B robots standing, booted from their true
    state and put in LOCOMOTION (the SRB sim has no posture-derived
    support forces, so the JAX tests skip the stand-up there)."""
    sim = srb_sim.srb_sim_init(params, batch)
    st = runner_init(config, params, srb_sim.observe(
        params, sim, torch.ones(batch, 4, device=sim.t.device)))
    st.fsm.state[:] = FsmState.LOCOMOTION
    return sim, st


def srb_tick(config: RunnerConfig, params: RobotParams, sim, st,
             cmd: TwistCommand, fsm_request=None):
    """One ground-truth runner tick on the SRB sim, as the JAX tests run
    it: the observed contact is the gait's stance, and outside LOCOMOTION
    every foot stays planted and no joint swings. Returns (sim, runner
    state, HybridCommand, forces)."""
    obs = srb_sim.observe(params, sim, stance_contact_mask(st.locomotion.gait))
    command, forces, st, _ = runner_step(config, params, st, cmd,
                                         observation=obs,
                                         fsm_request=fsm_request)
    in_loco = (st.fsm.state == FsmState.LOCOMOTION)[:, None]
    stance = stance_contact_mask(st.locomotion.gait)
    sim = srb_sim.srb_sim_step(
        params, sim, forces, torch.where(in_loco, stance, 1.0), command.q,
        command.dq, torch.where(
            in_loco, 1.0 - torch.repeat_interleave(stance, 3, -1), 0.0), DT)
    return sim, st, command, forces


# --- the fixture's windows ---------------------------------------------------

def fixture_noise(ticks: int = FIXTURE_TICKS) -> np.ndarray:
    """[ticks, 4, 30] standard normals of the fixture's JAX run (numpy,
    FIXTURE_SEED); the fixture keeps its first two ticks to show that the
    stream is the same."""
    rng = np.random.default_rng(FIXTURE_SEED)
    return rng.standard_normal((ticks, len(FIXTURE_VX), NOISE_DIM)).astype(
        np.float32)


def _concat(parts):
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts, axis=0)


def window_loop(data, keys=tuple(CHECKPOINTS), device=None,
                config: RunnerConfig | None = None):
    """The windows `keys` of the fixture `data` (an np.load of
    tests/data/runner_a1.npz) as one batch resumed from the JAX states:
    (loop, {key: rows}, noise [T, B, 30] for the longest window)."""
    device = card.resolve(device)
    params = a1_params(device)
    config = default_config(device) if config is None else config
    state = _concat([unflatten(data, f"{key}/state") for key in keys])
    n = len(FIXTURE_VX)
    rows = {key: slice(n * i, n * i + n) for i, key in enumerate(keys)}
    ticks = max(CHECKPOINTS[key][1] for key in keys)
    full = fixture_noise()
    # Past the end of the JAX run (windows run to the longest one) the
    # noise is zero.
    full = np.concatenate([full, np.zeros_like(full[:ticks])])
    noise = np.concatenate([full[CHECKPOINTS[key][0]:][:ticks]
                            for key in keys], axis=1)
    loop = Loop(config, params, fb.build_model(params), wb.ContactModel(),
                TwistCommand.constant(
                    vx=np.tile(np.asarray(FIXTURE_VX, np.float32), len(keys)),
                    body_height=0.27, device=device),
                to_torch(state["sim"], wb.WholeBodySimState, device=device),
                to_torch(state["runner"], RunnerState, device=device),
                torch.as_tensor(state["prev_v"], device=device),
                _per_scenario(np.tile(FIXTURE_NOISE, len(keys)),
                              len(keys) * n, device), None)
    return loop, rows, torch.as_tensor(noise, device=device)


def tile(loop: Loop, batch: int, vx, noise, seed: int = 0) -> Loop:
    """The loop's scenarios repeated to `batch`, with new forward speeds,
    noise levels (numbers or [batch] arrays) and generator."""
    idx = torch.arange(batch, device=loop.prev_v.device) \
        % loop.prev_v.shape[0]
    device = loop.prev_v.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return loop._replace(
        sim=tree.index(loop.sim, idx), runner=tree.index(loop.runner, idx),
        prev_v=loop.prev_v[idx],
        cmd=TwistCommand.constant(vx=np.asarray(vx, np.float32),
                                  body_height=0.27, batch=batch,
                                  device=device),
        noise=_per_scenario(noise, batch, device), generator=gen)


def window_errors(data, traces: dict, rows: dict) -> dict:
    """{key: {quantity: (port error, limit)}} of the port's window traces
    (run's `traces` of window_loop's batch) against the fixture over the
    ticks both hold; FSM states and contact flags must be equal (raises
    AssertionError otherwise)."""
    out = {}
    for key, r in rows.items():
        ticks = min(traces["fsm"].shape[1],
                    data[f"{key}/trace/fsm"].shape[1])
        got = {k: v[r, :ticks].cpu().numpy() for k, v in traces.items()}
        want = {k: data[f"{key}/trace/{k}"][:, :ticks]
                for k in ("fsm", "contact") + tuple(FLOOR)}
        for k in ("fsm", "contact"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{key} {k}")
        out[key] = {k: (float(np.max(np.abs(got[k] - want[k]))),
                        max(FACTOR * float(data[f"{key}/spread/{k}"]),
                            FLOOR[k]))
                    for k in FLOOR}
    return out


def measure(batch: int, steps: int = STEPS, device=None,
            start: str = "boot") -> dict:
    """Time `steps` ticks from the sitting boot (noise 1) or from the
    fixture's pre-switch checkpoint tiled to the batch (vx ~ U(0.15, 0.3)),
    after two untimed ticks."""
    device = card.resolve(device)
    if start == "boot":
        loop = build(batch, device)
    else:
        base, _, _ = window_loop(np.load(FIXTURE), ("switch",), device)
        vx = 0.15 + 0.15 * np.random.default_rng(0).random(batch)
        loop = tile(base, batch, vx, 1.0)
    run(loop, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = run(loop, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"ms_per_tick": 1e3 * wall / steps,
            "ticks_per_s": batch * steps / wall,
            "robot_seconds_per_wall_second": batch * steps * DT / wall,
            "alive_fraction": alive(out).mean().item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--start", choices=("boot", "switch"), default="boot")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("runner: no CUDA device; the benchmark measures "
                         "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure(a.batch, a.steps, start=a.start)
    print(json.dumps(dict(
        metric=f"robot runner on the whole-body sim ({a.start}, "
               f"batch={a.batch})", **res, card=card.name_and_power_limit())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
