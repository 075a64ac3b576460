"""Whole-body controller ticks per second on one card.

    python -m quadruped_tpu_torch.benchmarks.wbc [--batch 1024] [--reps 20]

Twin of the JAX package's benchmarks/bench_wbc.py. One tick is the full
WBC pipeline for one robot at 4 contacts: the floating-base model update
(mass matrix, gravity and Coriolis forces, contact Jacobians), the
kinematic multitask projection and the WBIC QP (`control/wbc.py::wbc_step`).
The states are drawn as that file draws them, from `default_rng(0)`: stand
angles plus N(0, 0.05) joint noise, N(0, 0.2) joint velocities. Prints one
JSON line with ticks/s and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from quadruped_tpu_torch.control import wbc
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.utils import card

FEET = [[0.17, -0.13, 0.0], [0.17, 0.13, 0.0], [-0.17, -0.13, 0.0],
        [-0.17, 0.13, 0.0]]


def build(batch: int, device=None):
    """(step, (obs, cmd)): `step(obs, cmd)` is one batched WBC tick on the
    card unless `device` says otherwise."""
    device = card.resolve(device)
    params = a1_params(device)
    model = fb.build_model(params)
    rng = np.random.default_rng(0)
    q = (np.tile([0.0, 0.8, -1.6], (batch, 4)).reshape(batch, 12)
         + rng.normal(size=(batch, 12)) * 0.05)
    dq = rng.normal(size=(batch, 12)) * 0.2

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def const(*row):
        return f32(np.tile(np.asarray(row, np.float32), (batch, 1)))

    zeros3 = const(0.0, 0.0, 0.0)
    obs = RobotObservation(
        base_position=const(0.0, 0.0, 0.27), base_rpy=zeros3,
        base_quat=const(1.0, 0.0, 0.0, 0.0), base_vel_world=zeros3,
        base_omega_world=zeros3, base_omega_body=zeros3,
        joint_angles=f32(q), joint_velocities=f32(dq),
        foot_contact=const(1.0, 1.0, 1.0, 1.0),
        foot_forces=const(30.0, 30.0, 30.0, 30.0))
    zeros43 = f32(np.zeros((batch, 4, 3)))
    fr = np.zeros((batch, 4, 3), np.float32)
    fr[:, :, 2] = 32.0
    cmd = wbc.WbcCommand(
        p_body_des=const(0.0, 0.0, 0.28), v_body_des=const(0.3, 0.0, 0.0),
        a_body_des=zeros3, rpy_des=zeros3, omega_des_world=zeros3,
        p_foot_des=f32(np.tile(FEET, (batch, 1, 1))), v_foot_des=zeros43,
        a_foot_des=zeros43, fr_des=f32(fr),
        contact_state=const(1.0, 1.0, 1.0, 1.0))
    config = wbc.WbcConfig()

    def step(o, c):
        return wbc.wbc_step(config, params, model, o, c)

    return step, (obs, cmd)


def ticks_per_s(step, args, batch: int, reps: int) -> float:
    """Scenario ticks per second over `reps` synchronized ticks, after one
    untimed tick."""
    step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(*args)
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wbc: no CUDA device; the benchmark measures the "
                         "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    step, args = build(a.batch)
    rate = ticks_per_s(step, args, a.batch, a.reps)
    print(json.dumps({
        "metric": f"WBC ticks/s (full model update + projection + WBIC, "
                  f"batch={a.batch})",
        "value": rate, "unit": "ticks/s",
        "card": card.name_and_power_limit()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
