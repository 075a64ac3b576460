"""Whole-body closed loop: 18-DoF closed-loop ticks per second on one card.

    python -m quadruped_tpu_torch.benchmarks.whole_body [--batch 1024]
        [--steps 500]

Twin of the JAX package's benchmarks/bench_whole_body.py: the
full-fidelity path, `observe` -> `locomotion_step` -> `whole_body_step`
(18-DoF Featherstone forward dynamics, Hunt-Crossley contact, the hybrid
motor law) under the advanced-trot MPC, whose every solve runs the
`fused_admm` kernel on the card. Configuration: A1, ADVANCED_TROT,
`MpcConfig(horizon=10, qp_cold_iters=120)`, vx = 0.2 + 0.4 U from
`default_rng(0)`, body height 0.27 m. One tick is 2 ms of sim time, so
ticks/s / 500 is simulated robot-seconds per wall second: how many
real-time simulator instances (Gazebo at a real-time factor of 1) the card
stands in for. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    LocomotionState,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.sim import whole_body as wb
from quadruped_tpu_torch.utils import card

DT = 0.002
STEPS = 500        # 1 s of sim
ALIVE_HEIGHT = 0.15


class Loop(NamedTuple):
    """The closed loop's fixed parts and its state."""

    config: LocomotionConfig
    params: RobotParams
    model: fb.FloatingBaseModel
    contact: wb.ContactModel
    cmd: TwistCommand
    sim: wb.WholeBodySimState
    ctrl: LocomotionState
    step: int = 0      # ticks done


def default_config(device) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(device))


def build(batch: int, device=None, config: LocomotionConfig | None = None,
          vx=None, params: RobotParams | None = None,
          body_height=0.27) -> Loop:
    """B A1 robots (or `params`: one robot, or a fleet of B) standing on
    flat ground with their controllers booted (the MPC cold start runs
    here); on the card unless `device` says otherwise. vx: [B] forward
    speeds (default 0.2 + 0.4 U); body_height: the commanded height, a
    number or [B]."""
    device = card.resolve(device)
    params = a1_params(device) if params is None else params
    model = fb.build_model(params)
    contact = wb.ContactModel()
    config = default_config(device) if config is None else config
    if vx is None:
        vx = 0.2 + 0.4 * np.random.default_rng(0).random(batch)
    sim = wb.whole_body_init(params, batch)
    ctrl = locomotion_init(config, params,
                           wb.observe(params, model, sim, contact))
    cmd = TwistCommand.constant(vx=np.asarray(vx, np.float32),
                                body_height=body_height, batch=batch,
                                device=device)
    return Loop(config, params, model, contact, cmd, sim, ctrl)


def run(loop: Loop, steps: int):
    """Advance the closed loop by `steps` ticks. Returns (loop, (heights,
    vx)): the base height and world forward velocity after each tick,
    [B, T] each."""
    sim, ctrl = loop.sim, loop.ctrl
    b, device = sim.t.shape[0], sim.t.device
    dt32 = np.float32(DT)
    hs, vxs = [], []
    for i in range(loop.step, loop.step + steps):
        obs = wb.observe(loop.params, loop.model, sim, loop.contact)
        t = torch.full((b,), float(np.float32(i + 1) * dt32),
                       dtype=torch.float32, device=device)
        command, _, ctrl = locomotion_step(loop.config, loop.params, ctrl,
                                           obs, loop.cmd, t)
        sim, _ = wb.whole_body_step(loop.params, loop.model, sim, command,
                                    loop.contact, DT)
        s = sim.fb
        hs.append(s.position[:, 2])
        vxs.append(torch.einsum("bij,bj->bi", se3.quat_to_rotmat(s.quat),
                                s.vel_body)[:, 0])
    loop = loop._replace(sim=sim, ctrl=ctrl, step=loop.step + steps)
    return loop, (torch.stack(hs, 1), torch.stack(vxs, 1))


def alive(loop: Loop) -> torch.Tensor:
    """[B] 1.0 where the base stands above 0.15 m (the JAX benchmark's
    criterion)."""
    return (loop.sim.fb.position[:, 2] > ALIVE_HEIGHT).float()


def measure(batch: int, steps: int = STEPS, device=None) -> dict:
    """Time one run of `steps` ticks from the booted state, after two
    untimed ticks."""
    loop = build(batch, device)
    run(loop, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = run(loop, steps)
    torch.cuda.synchronize()
    rate = batch * steps / (time.perf_counter() - t0)
    return {"ticks_per_s": rate, "gazebo_equivalents": rate / 500.0,
            "alive_fraction": alive(out).mean().item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("whole_body: no CUDA device; the benchmark "
                         "measures the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure(a.batch, a.steps)
    print(json.dumps({
        "metric": f"whole-body 18-DoF closed-loop ticks/s (Featherstone + "
                  f"contact + MPC trot, batch={a.batch})",
        "value": res["ticks_per_s"], "unit": "ticks/s",
        "alive_fraction": res["alive_fraction"],
        "gazebo_equivalents": res["gazebo_equivalents"],
        "card": card.name_and_power_limit()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
