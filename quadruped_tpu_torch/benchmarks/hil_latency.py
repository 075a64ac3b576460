"""Hardware-in-the-loop tick latency: the host bridge and the port's
control tick, end to end.

    python -m quadruped_tpu_torch.benchmarks.hil_latency [--fleets 1,16]
        [--ticks 300] [--device cpu]

Twin of the JAX package's benchmarks/hil_latency.py. A feeder thread plays
the robots' MCUs, streaming state packets at 1 kHz to a `FleetBridge`;
one tick is: `FleetBridge.gather_tensor` (the native snapshot into a
pinned buffer and one copy to the device), the observation built from the
rows (`obs_from_rows`), the port's `locomotion_step` (A1, ADVANCED_TROT,
`MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120)`, vx = 0.2 m/s;
its MPC solve's ADMM loop is K1 on the card), the command fetched to the
host, and `FleetBridge.send` (torque-clipped per robot). Each robot's
commands go to a sink socket that counts them.

The JAX tick runs under `jax.vmap`, where the cadence `cond` becomes a
select, so every JAX tick solves. The port's tick solves only on cadence
ticks (one in 8), so the report gives solve ticks and hold ticks apart,
each with p50, p99 and max; `solve_mode="always"` (every tick solves, the
JAX worst case) is a third run. Each run is held against the reference's
budgets: the 2 ms control tick (p50) and the 15 ms MPC period (p99), as
the JAX script defines them. Every port is taken from the OS. Prints one
JSON line (with the card's name and power limit on the card).
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time

import numpy as np
import torch

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.gait import ADVANCED_TROT
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.runtime.bridge import STATE_FLOATS, FleetBridge
from quadruped_tpu_torch.solvers import fused_admm
from quadruped_tpu_torch.utils import card

TICK_BUDGET_MS = 2.0      # 500 Hz control tick
PERIOD_BUDGET_MS = 15.0   # the MPC period
T_START = 0.015           # the JAX script's first tick time
DT = 0.002
MODES = ("cadence", "always")
FEEDER_HZ = 1000.0        # the MCUs' state rate, the JAX script's feeder
TORQUE_LIMIT = 23.0       # N m, the JAX script's FleetBridge clip


def make_state_packet(tick, q):
    vals = np.zeros(STATE_FLOATS, np.float32)
    vals[0] = tick
    vals[1] = 1.0                      # quat w
    vals[11:23] = q
    vals[47:51] = 30.0                 # foot forces: in contact
    return vals.tobytes()


def boot_rows(n: int) -> np.ndarray:
    """The state rows the feeder streams (tick column aside)."""
    rows = np.zeros((n, STATE_FLOATS), np.float32)
    rows[:, 1] = 1.0
    rows[:, 11:23] = 0.3
    rows[:, 47:51] = 30.0
    return rows


def feeder(stop: threading.Event, ports):
    """Plays the robot MCUs: streams state packets at FEEDER_HZ per
    robot."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    q = np.full(12, 0.3, np.float32)
    i = 0
    while not stop.is_set():
        i += 1
        pkt = make_state_packet(i, q)
        for p in ports:
            tx.sendto(pkt, ("127.0.0.1", p))
        time.sleep(1.0 / FEEDER_HZ)
    tx.close()


def udp_port_block(n: int, tries: int = 100):
    """n sockets bound to consecutive UDP ports starting at an OS-given
    one; returns (base port, sockets)."""
    for _ in range(tries):
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        socks = [probe]
        try:
            for i in range(1, n):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base, socks
        except OSError:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free UDP ports")


def obs_from_rows(rows: torch.Tensor) -> RobotObservation:
    """Observation of the [n, 51] state rows (the JAX script's
    obs_from_rows): attitude and rates from the IMU columns, joints from
    the motor columns, contact where a foot force exceeds 5 N; position
    and velocity are not measured and stay at the stand."""
    n = rows.shape[0]
    quat = rows[:, 1:5]
    omega = rows[:, 5:8]
    r = se3.quat_to_rotmat(quat)
    return RobotObservation(
        base_position=torch.tensor([0.0, 0.0, 0.27], dtype=rows.dtype,
                                   device=rows.device).expand(n, 3).clone(),
        base_rpy=se3.quat_to_rpy(quat), base_quat=quat,
        base_vel_world=torch.zeros_like(omega),
        base_omega_world=torch.einsum("bij,bj->bi", r, omega),
        base_omega_body=omega,
        joint_angles=rows[:, 11:23],
        joint_velocities=rows[:, 23:35],
        foot_contact=(rows[:, 47:51] > 5.0).to(rows.dtype),
        foot_forces=rows[:, 47:51])


def config(solve_mode: str = "cadence", device=None) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120,
                              solve_mode=solve_mode),
        swing=swing_mod.SwingConfig(),
        gait=ADVANCED_TROT(card.resolve(device)))


def tick(cfg: LocomotionConfig, params, cmd: TwistCommand, ctrl,
         rows: torch.Tensor, t: float):
    """One control tick on the rows: returns (ctrl, command [n, 60]: q, kp,
    dq, kd, tau blocks of 12, forces [n, 4, 3])."""
    n = rows.shape[0]
    tt = torch.full((n,), t, dtype=torch.float32, device=rows.device)
    hybrid, forces, ctrl = locomotion_step(cfg, params, ctrl,
                                           obs_from_rows(rows), cmd, tt)
    command = torch.cat([hybrid.q, hybrid.kp, hybrid.dq, hybrid.kd,
                         hybrid.tau], dim=1)
    return ctrl, command, forces


class HilRig:
    """n robots behind a FleetBridge, a feeder thread, a sink per robot,
    and the booted controller; close() (or a `with` block) stops the
    feeder and closes every socket."""

    def __init__(self, n: int, device=None, solve_mode: str = "cadence"):
        self.n = n
        self.device = card.resolve(device)
        self.fleet, self.stop, self.sinks = None, None, []
        try:
            self._open(n)
            self.config = config(solve_mode, self.device)
            self.params = a1_params(self.device)
            self.cmd = TwistCommand.constant(vx=0.2, body_height=0.27,
                                             batch=n, device=self.device)
            rows0 = torch.as_tensor(boot_rows(n), device=self.device)
            self.ctrl0 = locomotion_init(self.config, self.params,
                                         obs_from_rows(rows0))
        except BaseException:
            self.close()
            raise

    def _open(self, n: int):
        """The sinks, the bridge on free ports, and the feeder, once every
        robot's first state has arrived."""
        self.base_cmd, self.sinks = udp_port_block(n)
        for _ in range(20):
            base_state, probe = udp_port_block(n)
            for s in probe:
                s.close()
            try:
                self.fleet = FleetBridge(n, base_recv_port=base_state,
                                         base_send_port=self.base_cmd,
                                         torque_limit=TORQUE_LIMIT)
                break
            except RuntimeError:
                continue
        if self.fleet is None:
            raise RuntimeError("could not bind the fleet's state ports")
        self.stop = threading.Event()
        self.thread = threading.Thread(target=feeder, args=(
            self.stop, [base_state + i for i in range(n)]), daemon=True)
        self.thread.start()
        deadline = time.time() + 2.0
        while self.fleet.gather()[0] < n:
            if time.time() > deadline:
                raise RuntimeError("the feeder's states did not arrive")
            time.sleep(0.01)

    def drain(self) -> list:
        """The command packets each sink received since the last drain
        (waiting up to 1 s for the first)."""
        got = []
        for s in self.sinks:
            pkts = []
            s.settimeout(1.0)
            try:
                pkts.append(s.recv(4096))
                s.setblocking(False)
                while True:
                    pkts.append(s.recv(4096))
            except (BlockingIOError, socket.timeout):
                pass
            got.append(pkts)
        return got

    def run(self, ticks: int, warmup: int = 2, record: bool = False) -> dict:
        """`warmup` untimed ticks from the booted state (discarded), then
        `ticks` timed ticks from it again at t = 15 ms, 17 ms, ...
        Returns per-tick latency (ms), whether the tick solved, K1
        launches, the command packets each sink received and, with
        `record`, the rows, commands and forces of each tick."""
        for _ in range(warmup):
            _, rows, _ = self.fleet.gather_tensor(self.device)
            _, command, _ = tick(self.config, self.params, self.cmd,
                                 self.ctrl0, rows, T_START)
            self.fleet.send(command.cpu().numpy())
            self.drain()
        ctrl = self.ctrl0
        iteration = int(ctrl.mpc.iteration[0])
        every = self.config.mpc.ticks_per_solve
        out = {k: [] for k in ("ms", "solve", "k1", "received", "rows",
                               "commands", "forces")}
        t_sim = T_START
        for k in range(ticks):
            launches = fused_admm.fused_admm.launches
            t0 = time.perf_counter()
            _, rows, _ = self.fleet.gather_tensor(self.device)
            ctrl, command, forces = tick(self.config, self.params, self.cmd,
                                         ctrl, rows, t_sim)
            host = command.cpu().numpy()
            self.fleet.send(host)
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["solve"].append(self.config.mpc.solve_mode == "always"
                                or (iteration + k) % every == 0)
            out["k1"].append(fused_admm.fused_admm.launches - launches)
            received = self.drain()
            out["received"].append([len(p) for p in received])
            if record:
                out["rows"].append(rows.cpu().numpy())
                out["commands"].append(host)
                out["forces"].append(forces.cpu().numpy())
                out.setdefault("packets", []).append(
                    [np.frombuffer(p[-1], np.float32) for p in received])
            t_sim += DT
        return {k: np.asarray(v) for k, v in out.items()}

    def close(self):
        if self.stop is not None:
            self.stop.set()
            self.thread.join(timeout=2.0)
            self.stop = None
        if self.fleet is not None:
            self.fleet.close()
        for s in self.sinks:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def percentiles(ms) -> dict:
    ms = np.asarray(ms, np.float64)
    if ms.size == 0:
        return {"ticks": 0}
    return {"ticks": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()), "mean_ms": float(ms.mean())}


def summarize(res: dict) -> dict:
    """Solve ticks and hold ticks apart and together, against the 2 ms
    tick (p50) and the 15 ms period (p99) as the JAX script holds them."""
    ms, solve = res["ms"], res["solve"].astype(bool)
    every = percentiles(ms)
    return {"solve_ticks": percentiles(ms[solve]),
            "hold_ticks": percentiles(ms[~solve]), "all_ticks": every,
            "k1_launches": int(res["k1"].sum()),
            "within_2ms_tick_budget": bool(every["p50_ms"] < TICK_BUDGET_MS),
            "within_15ms_cadence_budget": bool(
                every["p99_ms"] < PERIOD_BUDGET_MS)}


def measure(n: int, ticks: int, device=None) -> dict:
    """Both modes at a fleet of n: {mode: summary}."""
    out = {}
    for mode in MODES:
        with HilRig(n, device, solve_mode=mode) as rig:
            res = rig.run(ticks)
        if not (res["received"] == 1).all():
            raise RuntimeError(f"fleet {n} {mode}: a sink missed a command")
        out[mode] = summarize(res)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleets", default="1,16")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    a = ap.parse_args(argv)
    device = card.resolve(a.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    results = {f"fleet_{n}": measure(n, a.ticks, device)
               for n in (int(x) for x in a.fleets.split(","))}
    print(json.dumps({
        "device": str(device),
        "card": card.name_and_power_limit() if device.type == "cuda"
        else None,
        "note": "cadence: the port solves one tick in 8 (solve and hold "
                "ticks apart); always: every tick solves, as every JAX "
                "tick does under jax.vmap",
        **results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
