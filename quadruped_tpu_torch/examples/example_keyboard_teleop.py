"""Interactive keyboard teleop (port of examples/example_keyboard_teleop.py;
the engine's `example_keyboard`).

Drives the closed-loop A1 trot on the SRB sim: a key read from the
terminal (w/s forward speed, a/d lateral, q/e yaw rate, space = stop,
x = quit) sets the command, then the loop advances CHUNK ticks under it
and prints the robot's state. Without a TTY, or with --script, a scripted
key sequence is replayed instead. Every MPC solve's ADMM loop is the
`fused_admm` kernel on the card (B=1, n=60, 40 iterations).

    python -m quadruped_tpu_torch.examples.example_keyboard_teleop
        [--script "wwqq  x"] [--chunks 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from quadruped_tpu_torch.control import mpc, swing, teleop
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.sim import srb_sim
from quadruped_tpu_torch.utils import card

CHUNK = 100  # control ticks (0.002 s each) per key poll
DT = 0.002
DEFAULT_SCRIPT = "wwww  x"


def config(device) -> LocomotionConfig:
    return LocomotionConfig(mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
                            swing=swing.SwingConfig(),
                            gait=ADVANCED_TROT(device))


class Teleop:
    """The closed loop advanced a chunk at a time; t0 is the chunk's start
    time, formed in float32 as the JAX script forms it."""

    def __init__(self, device):
        self.device = device
        self.params = a1_params(device)
        self.config = config(device)
        self.sim = srb_sim.srb_sim_init(self.params, 1)
        obs = srb_sim.observe(self.params, self.sim,
                              torch.ones(1, 4, device=device))
        self.state = locomotion_init(self.config, self.params, obs)
        self.cmd = TwistCommand.constant(body_height=self.params.body_height,
                                         device=device)
        self.t0 = np.float32(0.0)

    def chunk(self, cmd: TwistCommand, rec: common.Recorder | None = None,
              first: int = 0):
        """CHUNK ticks under `cmd`; with `rec`, the base position after
        each tick into its rows from `first` on."""
        self.cmd = cmd
        sim, state, p = self.sim, self.state, self.params
        for i in range(CHUNK):
            obs = srb_sim.observe(p, sim, stance_contact_mask(state.gait))
            t = torch.full((1,), float(self.t0 + np.float32(i + 1)
                                       * np.float32(DT)),
                           dtype=torch.float32, device=self.device)
            command, forces, state = locomotion_step(self.config, p, state,
                                                     obs, cmd, t)
            stance = stance_contact_mask(state.gait)
            sim = srb_sim.srb_sim_step(
                p, sim, forces, stance, command.q, command.dq,
                1.0 - torch.repeat_interleave(stance, 3, dim=-1), DT)
            if rec is not None:
                rec.put(first + i, position=sim.position[0])
        self.sim, self.state = sim, state
        self.t0 = np.float32(self.t0 + np.float32(CHUNK * DT))

    def report(self) -> str:
        pos = self.sim.position[0].tolist()
        vel = self.sim.vel_world[0].tolist()
        c = self.cmd
        return (f"  pos=({pos[0]:+.2f},{pos[1]:+.2f},{pos[2]:.3f}) "
                f"v=({vel[0]:+.2f},{vel[1]:+.2f}) "
                f"cmd vx={c.linear[0, 0].item():+.2f} "
                f"vy={c.linear[0, 1].item():+.2f} "
                f"wz={c.angular_z[0].item():+.2f}")


def run(script: str | None = DEFAULT_SCRIPT, chunks: int = 40, device=None,
        echo: bool = False) -> dict:
    """The scripted teleop: one chunk per key of `script` (up to `chunks`,
    stopping at x). Returns, per chunk, the position and world velocity
    after it and the command under it (linear [C, 3], wz [C]), and the
    base position after each tick (position_trace [T, 3]); with `echo`
    prints the script's line for each chunk."""
    device = card.resolve(device)
    keys = list(script or DEFAULT_SCRIPT)[:chunks]
    if "x" in keys:
        keys = keys[:keys.index("x")]
    loop = Teleop(device)
    ticks = common.Recorder(CHUNK * len(keys))
    chunk = common.Recorder(len(keys))
    with common.LoopClock(device) as clock:
        for n, key in enumerate(keys):
            cmd = teleop.apply_key(loop.cmd, key)
            loop.chunk(cmd, ticks, n * CHUNK)
            chunk.put(n, position=loop.sim.position[0],
                      vel_world=loop.sim.vel_world[0], linear=cmd.linear[0],
                      wz=cmd.angular_z[0])
            if echo:
                print(loop.report(), flush=True)
    out = chunk.numpy()
    out["position_trace"] = ticks.numpy()["position"]
    return common.timed(out, CHUNK * len(keys), clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--script", type=str, default=None,
                    help="scripted key sequence (no TTY needed)")
    ap.add_argument("--chunks", type=int, default=40,
                    help="max chunks in scripted mode")
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    if args.script is not None or not sys.stdin.isatty():
        print("scripted teleop:", list(args.script or DEFAULT_SCRIPT))
        out = run(args.script, args.chunks, device, echo=True)
        common.report(device, out)
        return 0

    print("keys: w/s = vx, a/d = vy, q/e = yaw rate, space = stop, x = quit")
    loop = Teleop(device)

    def on_key(new_cmd):
        loop.chunk(new_cmd)
        print(loop.report(), flush=True)

    teleop.keyboard_teleop_loop(on_key,
                                body_height=float(loop.params.body_height),
                                device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
