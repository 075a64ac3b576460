"""Hardware-in-the-loop skeleton: the native UDP bridge and a host loop at
--hz (port of examples/example_hardware_bridge.py; the engine's
`example_a1_real`).

The card runs one control tick (A1, ADVANCED_TROT, `MpcConfig(horizon=5,
qp_iters=40, iterations_per_mpc=30)`; every MPC solve's ADMM loop is the
`fused_admm` kernel at B=1, n=60, 40 iterations); the host runs the
absolute-deadline timer, pulls the latest state snapshot from the bridge
(`runtime.bridge`, the port's g++ build of native/robot_bridge.cpp),
builds the observation from it with one host-to-device copy, and sends
the hybrid command back over UDP. The tick is not held to the timer's
period: a tick longer than it shows in the jitter line.

Run against a real robot MCU (or a loopback MCU emulator, as
tests/test_torch_examples.py runs) by pointing --robot-ip at it.

    python -m quadruped_tpu_torch.examples.example_hardware_bridge --dry-run
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from quadruped_tpu_torch.benchmarks.hil_latency import obs_from_rows
from quadruped_tpu_torch.control import mpc, swing
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.examples import common
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.runtime import (LoopTimer, RobotBridge,
                                         native_available)
from quadruped_tpu_torch.runtime.bridge import (DR_CMD_RELEASE_CONTROL,
                                                DR_CMD_TAKE_CONTROL,
                                                STATE_FLOATS)
from quadruped_tpu_torch.utils import card

# The bridge's state dict in the order of its 51-float row.
STATE_FIELDS = ("tick", "quat", "gyro", "acc", "q", "dq", "tau",
                "foot_force")


def build_controller(device) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40, iterations_per_mpc=30),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT(device))


def state_row(s: dict) -> np.ndarray:
    """The bridge's state dict as its [51] float32 row."""
    return np.concatenate([np.atleast_1d(s[k]) for k in STATE_FIELDS]
                          ).astype(np.float32)


def obs_from_bridge_state(s: dict, device):
    """The observation of one state snapshot: one host-to-device copy of
    its row, the rest on the device (attitude and rates from the IMU,
    joints from the motors, contact where a foot force exceeds 5 N;
    position and velocity are not measured: the base stands at 0.27 m)."""
    return obs_from_rows(torch.as_tensor(state_row(s))[None].to(device))


def tick(config, params, ctrl, obs, cmd, t: float):
    """One control tick at time t (a Python float, rounded to float32 as
    the JAX script's jnp.asarray(t) rounds it)."""
    tt = torch.full((1,), t, dtype=torch.float32,
                    device=obs.base_position.device)
    return locomotion_step(config, params, ctrl, obs, cmd, tt)


def dry_run(device=None) -> dict:
    """One tick on the SRB sim's stand: the command's q, kp, dq, kd, tau
    [12] each."""
    from quadruped_tpu_torch.sim import srb_sim

    device = card.resolve(device)
    params = a1_params(device)
    config = build_controller(device)
    sim = srb_sim.srb_sim_init(params, 1)
    obs = srb_sim.observe(params, sim, torch.ones(1, 4, device=device))
    ctrl = locomotion_init(config, params, obs)
    cmd = TwistCommand.constant(vx=0.2, device=device)
    with common.LoopClock(device) as clock:
        command, _, _ = tick(config, params, ctrl, obs, cmd, 0.002)
    out = {k: getattr(command, k)[0].cpu().numpy()
           for k in ("q", "kp", "dq", "kd", "tau")}
    return common.timed(out, 1, clock)


def run(robot_ip: str = "127.0.0.1", wire: str = "native",
        state_port: int = 8007, cmd_port: int = 8008, hz: float = 500.0,
        seconds: float = 5.0, device=None) -> dict:
    """The UDP loop for int(seconds * hz) ticks. Returns the state rows it
    read (state [T + 1, 51], the boot's first), the commands it sent
    (command [T, 60]: q, kp, dq, kd, tau) and the timer's jitter (us);
    raises when the native bridge cannot be built."""
    device = card.resolve(device)
    if not native_available():
        raise SystemExit("native bridge not built (g++ required)")
    params = a1_params(device)
    config = build_controller(device)
    bridge = RobotBridge(recv_port=state_port, send_ip=robot_ip,
                         send_port=cmd_port,
                         torque_limit=float(params.torque_limit),
                         wire_mode=wire)
    timer = LoopTimer(hz)
    try:
        cmd = TwistCommand.constant(vx=0.0, device=device)
        if wire == "deeprobotics":
            # Take low-level control before streaming joint commands (the
            # vendor handshake, send_to_robot.h control_get ABLE). Losing
            # the >5 ms command cadence releases control on the robot side.
            bridge.send_simple(DR_CMD_TAKE_CONTROL)
        ticks = int(seconds * hz)
        rows = np.zeros((ticks + 1, STATE_FLOATS), np.float32)
        sent = np.zeros((ticks, 60), np.float32)
        _, s = bridge.get_state()
        rows[0] = state_row(s)
        ctrl = locomotion_init(config, params,
                               obs_from_bridge_state(s, device))
        t, dt = 0.0, 1.0 / hz
        with common.LoopClock(device) as clock:
            for i in range(ticks):
                timer.wait()
                _, s = bridge.get_state()
                rows[i + 1] = state_row(s)
                command, _, ctrl = tick(config, params, ctrl,
                                        obs_from_bridge_state(s, device),
                                        cmd, t)
                sent[i] = torch.cat([command.q, command.kp, command.dq,
                                     command.kd, command.tau],
                                    dim=1)[0].cpu().numpy()
                bridge.send_command(*sent[i].reshape(5, 12))
                t += dt
        out = common.timed({"state": rows, "command": sent,
                            "jitter_mean_us": timer.mean_jitter_us,
                            "jitter_max_us": timer.max_jitter_us},
                           ticks, clock)
        if wire == "deeprobotics":
            # Vendor-faithful soft handoff (send_to_robot.h
            # control_get(UNABLE)): stream a damping-only command (kp=0,
            # kd~5, zero targets) for ~2 s so the robot settles under joint
            # damping, then release low-level control: an immediate 0x0113
            # release hands the joints back abruptly on a real Lite2/Lite3.
            zeros = np.zeros(12, np.float32)
            kd_damp = np.full(12, 5.0, np.float32)
            for _ in range(int(2.0 * hz)):
                timer.wait()
                bridge.send_command(zeros, zeros, zeros, kd_damp, zeros)
            bridge.send_simple(DR_CMD_RELEASE_CONTROL)
        return out
    finally:
        timer.close()
        bridge.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot-ip", default="127.0.0.1")
    ap.add_argument("--wire", default="native",
                    choices=["native", "unitree", "deeprobotics"],
                    help="UDP wire format: the engine protocol, the real "
                         "Unitree LowState/LowCmd packets (A1/Go1/"
                         "Aliengo), or the real DeepRobotics EthCommand "
                         "packets (Lite2/Lite3)")
    ap.add_argument("--state-port", type=int, default=8007)
    ap.add_argument("--cmd-port", type=int, default=8008)
    ap.add_argument("--hz", type=float, default=500.0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="one tick on synthetic state, no UDP")
    common.add_device(ap)
    args = ap.parse_args(argv)
    device = card.resolve(args.device)
    if args.dry_run:
        out = dry_run(device)
        print("dry run OK; tau[0:6] =", out["tau"][:6].round(2))
        common.report(device, out)
        return 0
    out = run(args.robot_ip, args.wire, args.state_port, args.cmd_port,
              args.hz, args.seconds, device)
    print(f"ran {out['ticks']} ticks; timer jitter mean "
          f"{out['jitter_mean_us']:.1f}us max {out['jitter_max_us']:.1f}us")
    common.report(device, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
