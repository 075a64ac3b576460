"""The examples at the short lengths of their checks, held to the JAX
examples' traces in tests/data/examples_jax.npz (written by
tests/examples_jax.py): tests/test_torch_examples.py and
tests/test_torch_examples_walk.py, on the CPU and (their `cuda` cases) on
the card, where no JAX is installed.

Limits, port against JAX, taken from the existing tests of the same loops.
Every closed loop's fixture also keeps JAX's own run from the base one
float32 step up (`nudged`), and a trace may differ from JAX's by FACTOR
(10) times that spread or by its floor, whichever is larger:

* the SRB MPC loops (`example_a1_trot`, `example_aliengo_wbc_trot`,
  `example_fleet_sweep`, `example_keyboard_teleop`): the rule of the
  fleet fixture (benchmarks/fleet.py): over the first HEAD ticks
  tests/test_torch_rollout.py's limits (heights 2e-4 m, velocities 5e-3
  m/s, and at H=5 stance forces 1% of the robot's m*g; its H=10 fixture
  test holds no forces, which the Newton-Schulz rounding moves by ~1 N
  at H=10), over the run 10x JAX's spread with floors of 1e-5 m, 1e-4
  m/s and 1% m*g; alive masks and commands equal. The H=10 loop
  (`example_a1_trot`) holds its forces over the run to H10_FORCE_TOL,
  set from readings in place of 10x JAX's spread (9.0 N): the port reads
  0.94 N on the CPU and 1.37 N on the card, JAX's own nudged run 0.90 N,
  and the loop at 24 ADMM iterations in place of 40 reads 2.10 N on the
  CPU, under test_torch_rollout.py's golden gate of 3% m*g (3.8 N);
* the bridge's commands (`example_hardware_bridge`, no sim in its loop):
  joint targets 2e-3 rad and 5e-2 rad/s (test_torch_rollout.py's q and
  dq), torques 0.3 N m (test_torch_hil.py's TAU_TOL), gains equal;
* the whole-body trot (`example_viz3d`): test_torch_whole_body.py's
  CLOSED_TOL, positions 2e-3 m, attitude 4e-3 (its quaternion limit, on
  roll-pitch-yaw), joint angles 4e-2 rad;
* the runner (`example_whole_body_standup`): test_torch_runner.py's rule,
  FSM states equal, positions within 10x JAX's spread or 1e-5 m;
* the walks (`example_lite3_walk`, `example_stair_climb`,
  `example_gap_crossing`): test_torch_walk_windows.py's rule, sub-states
  equal, positions within 10x JAX's spread or 1e-5 m, joint angles and
  attitude within 10x or 1e-3 rad.

Contact flags of the whole-body sim flip on a touchdown that rounding
moves by a tick, so the port may differ from JAX on at most FLAG_SLACK
more (tick, leg) flags than JAX's own nudged run does.
"""

from __future__ import annotations

import math
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "data" / "examples_jax.npz"
MG_A1 = 13.0 * 9.81
G = 9.81
FLAG_SLACK = 2
FACTOR = 10.0

# example -> keyword arguments of its short run (the bridge's are below).
SHORT = {
    "a1_trot": {"steps": 200},
    "aliengo_wbc_trot": {"steps": 100},
    "fleet_sweep": {"steps": 60},
    "keyboard_teleop": {"script": "wq"},
    "whole_body_standup": {"steps": 200},
    "viz3d": {"steps": 100},
    "lite3_walk": {"steps": 150},
    "stair_climb": {"seconds": 0.2},
    "gap_crossing": {"seconds": 0.2},
}
BRIDGE_TICKS, BRIDGE_HZ = 50, 500.0
WIRES = ("native", "unitree", "deeprobotics")

# The first HEAD ticks of an SRB trace at test_torch_rollout.py's limits
# (forces: 1% m*g, at H=5 only); the H=10 loops' forces over the run (N);
# the trace's tick axis.
HEAD = 24
HEAD_TOL = {"base_height_trace": 2e-4, "vel_trace": 5e-3,
            "forces_trace": 0.01}
H10 = ("a1_trot",)
H10_FORCE_TOL = 1.75
TICK_AXIS = {"fleet_sweep": 1}
COMMAND_TOL = {"q": 2e-3, "dq": 5e-2, "tau": 0.3, "kp": 0.0, "kd": 0.0}
VIZ3D_TOL = {"position": 2e-3, "rpy": 4e-3, "q": 4e-2}
# Floors of the spread rule (forces: a share of m*g).
SPREAD_FLOOR = {"position": 1e-5, "base_height_trace": 1e-5,
                "vel_trace": 1e-4, "vel_world": 1e-4, "forces_trace": 0.01,
                "q": 1e-3, "rpy": 1e-3}
EQUAL = ("alive", "linear", "wz", "fsm", "sub_state")


def module(name: str):
    """The port's examples/example_<name>.py module."""
    import importlib

    return importlib.import_module(
        f"quadruped_tpu_torch.examples.example_{name}")


def short_run(name: str, device) -> dict:
    """The example's `run` at the length of its check."""
    return module(name).run(**SHORT[name], device=device)


def mpc_config(name: str):
    """The MpcConfig of an example that solves an MPC."""
    mod = module(name)
    if name == "hardware_bridge":
        return mod.build_controller("cpu").mpc
    if name == "fleet_sweep":
        return mod.fleet.config(None).mpc
    return mod.config(device="cpu").mpc


def k1_launches(name: str, ticks: int) -> int:
    """fused_admm launches of `ticks` ticks of an example from its boot:
    the boot's cold start and one a batched MPC solve, one a cadence
    period; none on the walks, and only the boot's on the runner's
    STAND_UP ramp, which the short standup does not leave."""
    if name in ("lite3_walk", "stair_climb", "gap_crossing"):
        return 0
    if name == "whole_body_standup":
        return 1
    return 1 + math.ceil(ticks / mpc_config(name).ticks_per_solve)


def _err(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0


def _flags(got, want, nudged) -> tuple[int, int]:
    """(flags where the port differs from JAX, the most allowed: JAX's own
    nudged run's count plus FLAG_SLACK)."""
    n_port = int(np.sum(np.asarray(got) != want))
    return n_port, int(np.sum(nudged != want)) + FLAG_SLACK


def errors(name: str, got: dict, data) -> dict:
    """{quantity: (port error, limit)} of the short run `got` of example
    `name` against the fixture `data` (an np.load of FIXTURE); the
    quantities held equal are checked here (AssertionError)."""
    prefix = f"{name}/"
    keys = [k[len(prefix):] for k in data.files
            if k.startswith(prefix) and "/nudged/" not in k]
    mg = G * robot_mass(name)
    out = {}
    for key in keys:
        want = data[prefix + key]
        g = np.asarray(got[key])
        assert g.shape == want.shape, (name, key, g.shape, want.shape)
        if key in EQUAL:
            np.testing.assert_array_equal(g, want, err_msg=f"{name} {key}")
            continue
        nk = f"{prefix}nudged/{key}"
        nudged = data[nk] if nk in data.files else None
        if key == "contact":
            out[key] = _flags(g, want, nudged)
        elif name == "viz3d":
            out[key] = (_err(g, want), VIZ3D_TOL[key])
        elif nudged is not None:
            floor = SPREAD_FLOOR[key] * (mg if key == "forces_trace" else 1)
            lim = max(FACTOR * _err(nudged, want), floor)
            if key == "forces_trace" and name in H10:
                lim = H10_FORCE_TOL
            out[key] = (_err(g, want), lim)
            if key in HEAD_TOL and not (key == "forces_trace"
                                        and name in H10):
                head = (slice(None),) * TICK_AXIS.get(name, 0) \
                    + (slice(0, HEAD),)
                out[f"{key}@head"] = (
                    _err(g[head], want[head]),
                    HEAD_TOL[key] * (mg if key == "forces_trace" else 1))
        else:
            out[key] = (_err(g, want), COMMAND_TOL[key])
    return out


def robot_mass(name: str) -> float:
    from quadruped_tpu_torch.robots import aliengo_params

    if name == "aliengo_wbc_trot":
        return float(aliengo_params("cpu").total_mass)
    return MG_A1 / G


def over(errs: dict) -> dict:
    """The quantities of `errors` over their limits."""
    return {k: e for k, (e, lim) in errs.items() if not e <= lim}


# --- the bridge example over UDP loopback -----------------------------------

# Bytes of one command packet on each wire, and of the DeepRobotics
# handshake's single-value command.
COMMAND_BYTES = {"native": 240, "unitree": 730, "deeprobotics": 252}
SIMPLE_BYTES = 12


def _crc32_unitree(data: bytes) -> int:
    """Unitree CRC-32 (poly 0x04c11db7, init 0xFFFFFFFF, word-wise, no
    reflection) over every 32-bit word but the trailing CRC word."""
    crc = 0xFFFFFFFF
    for i in range((len(data) >> 2) - 1):
        (word,) = struct.unpack_from("<I", data, 4 * i)
        for bit in range(31, -1, -1):
            crc = ((crc << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 if crc & 0x80000000
                                               else 0)
            if word >> bit & 1:
                crc ^= 0x04C11DB7
    return crc


def wire_state_packet(mode: str) -> bytes:
    """A state packet of each wire protocol, written at the spec offsets
    (nothing shared with the C++ codec): joint j at 0.3 + 0.01 j in
    `native` and `unitree`, wire joint w at 1.0 + 0.01 w in
    `deeprobotics`."""
    if mode == "native":
        vals = np.zeros(51, np.float32)
        vals[0], vals[1] = 5.0, 1.0
        vals[11:23] = 0.3 + 0.01 * np.arange(12)
        vals[47:51] = 30.0
        return vals.tobytes()
    if mode == "unitree":
        buf = bytearray(891)
        buf[0] = 0xFF
        struct.pack_into("<4f", buf, 10, 1.0, 0.0, 0.0, 0.0)
        for j in range(20):
            buf[63 + 38 * j] = 0x0A
            struct.pack_into("<f", buf, 63 + 38 * j + 1, 0.3 + 0.01 * j)
        struct.pack_into("<4h", buf, 823, 10, 20, 30, 40)
        struct.pack_into("<I", buf, 839, 123456)
        struct.pack_into("<I", buf, 887, _crc32_unitree(bytes(buf)))
        return bytes(buf)
    payload = bytearray(336)
    struct.pack_into("<I", payload, 0, 2500)
    for w in range(12):
        struct.pack_into("<4f", payload, 44 + 16 * w, 1.0 + 0.01 * w, 0.0,
                         0.0, 35.0)
    return struct.pack("<III", 0x0906, 336, 1 | (7 << 8)) + bytes(payload)


class LoopbackMcu:
    """A robot's MCU on UDP loopback: streams `packet` to the bridge's
    state port every `period` s and keeps the size of every packet the
    bridge sends to its command port. A `with` block starts and stops its
    threads and closes its sockets."""

    def __init__(self, packet: bytes, period: float = 0.001):
        self.packet, self.period = packet, period
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("127.0.0.1", 0))
        self.rx.settimeout(0.05)
        self.cmd_port = self.rx.getsockname()[1]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            probe.bind(("127.0.0.1", 0))
            self.state_port = probe.getsockname()[1]
        self.sizes: list[int] = []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._send, self._receive)]

    def _send(self):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            while not self._stop.is_set():
                tx.sendto(self.packet, ("127.0.0.1", self.state_port))
                time.sleep(self.period)

    def _receive(self):
        while not self._stop.is_set():
            try:
                self.sizes.append(len(self.rx.recv(4096)))
            except socket.timeout:
                continue

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        time.sleep(0.2)            # the last commands reach the socket
        self._stop.set()
        for t in self._threads:
            t.join()
        self.rx.close()


def bridge_run(wire: str, packet: bytes, device) -> dict:
    """The bridge example's UDP loop for BRIDGE_TICKS ticks at BRIDGE_HZ
    against a LoopbackMcu streaming `packet`; the run's traces with the
    sizes of the packets the MCU received (`received`)."""
    with LoopbackMcu(packet) as mcu:
        out = module("hardware_bridge").run(
            wire=wire, state_port=mcu.state_port, cmd_port=mcu.cmd_port,
            hz=BRIDGE_HZ, seconds=BRIDGE_TICKS / BRIDGE_HZ, device=device)
    out["received"] = np.asarray(mcu.sizes)
    return out


def bridge_errors(wire: str, got: dict, data) -> tuple[dict, str]:
    """({command block: (port error, limit)}, the boot's row: `boot_packet`
    or `boot_empty`) of a `bridge_run` against the JAX loop on the rows it
    read. The boot read the MCU's packet or, when
    none had arrived yet, the bridge's empty snapshot (the fixture keeps
    both); every tick must have read the packet, and the MCU must have
    received one command a tick (and in `deeprobotics` the take-control
    command first, the 2 s damping stream and the release last)."""
    row = data[f"bridge_{wire}/row"]
    states = got["state"]
    boot = "boot_packet" if states[0].any() else "boot_empty"
    if boot == "boot_packet":
        np.testing.assert_array_equal(states[0], row)
    np.testing.assert_array_equal(
        states[1:], np.broadcast_to(row, states[1:].shape),
        err_msg=f"{wire}: a tick read no packet of the MCU")
    ticks = len(states) - 1
    sizes = got["received"].tolist()
    want_sizes = [COMMAND_BYTES[wire]] * ticks
    if wire == "deeprobotics":
        want_sizes = ([SIMPLE_BYTES] + want_sizes
                      + [COMMAND_BYTES[wire]] * int(2.0 * BRIDGE_HZ)
                      + [SIMPLE_BYTES])
    assert sizes == want_sizes, (wire, len(sizes), len(want_sizes))
    want = data[f"bridge_{wire}/{boot}"]
    out = {}
    for j, key in enumerate(("q", "kp", "dq", "kd", "tau")):
        blk = slice(12 * j, 12 * j + 12)
        out[key] = (_err(got["command"][:, blk], want[:, blk]),
                    COMMAND_TOL[key])
    return out, boot


def bridge_dry_run(device) -> dict:
    """The bridge example's --dry-run (one tick), the fixture's
    `bridge_dry_run`."""
    return module("hardware_bridge").dry_run(device)
