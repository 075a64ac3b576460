"""ctypes bindings of the host runtime native/robot_bridge.cpp (port of
quadruped_tpu/runtime/bridge.py).

The host-side seam to real robots: UDP low-level state and command
protocols with a receive thread per robot, a torque safety clip, and a
low-jitter loop timer. The port builds the library itself with g++ into
`quadruped_tpu_torch/_build/` (`utils/host_build.py`) and never touches
the JAX bridge's `native/libqtpu_bridge.so`. A failed build raises with
g++'s log.

`FleetBridge.gather()` returns numpy, as in JAX; `gather_tensor(device)`
returns the [n, 51] state rows and the live mask as tensors on the
caller's device: the one host-to-device copy of a control tick, from a
pinned buffer when the device is the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from quadruped_tpu_torch.utils import host_build

STATE_FLOATS = 51
COMMAND_FLOATS = 60

WIRE_MODES = {"native": 0, "unitree": 1, "deeprobotics": 2}

# DeepRobotics single-value control codes (send_to_robot.h:33-34,
# control_get / robot_state_init): take / release low-level control and
# the boot-time state init handshake around the joint-command stream.
DR_CMD_TAKE_CONTROL = 0x0114
DR_CMD_RELEASE_CONTROL = 0x0113
DR_CMD_STATE_INIT = 0x31010C05

_F = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "qtpu_bridge_create": (ctypes.c_void_p, [ctypes.c_uint16,
                                             ctypes.c_char_p,
                                             ctypes.c_uint16,
                                             ctypes.c_float]),
    "qtpu_bridge_create_wire": (ctypes.c_void_p, [
        ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_float,
        ctypes.c_int]),
    "qtpu_bridge_destroy": (None, [ctypes.c_void_p]),
    "qtpu_bridge_get_state": (ctypes.c_uint64, [ctypes.c_void_p, _F]),
    "qtpu_bridge_send_command": (ctypes.c_int, [ctypes.c_void_p, _F]),
    "qtpu_bridge_send_simple": (ctypes.c_int, [ctypes.c_void_p,
                                               ctypes.c_uint32,
                                               ctypes.c_uint32]),
    "qtpu_fleet_create": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_uint16,
                                            ctypes.c_char_p, ctypes.c_uint16,
                                            ctypes.c_float]),
    "qtpu_fleet_create_wire": (ctypes.c_void_p, [
        ctypes.c_int, ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16,
        ctypes.c_float, ctypes.c_int]),
    "qtpu_fleet_destroy": (None, [ctypes.c_void_p]),
    "qtpu_fleet_size": (ctypes.c_int, [ctypes.c_void_p]),
    "qtpu_fleet_gather": (ctypes.c_int, [ctypes.c_void_p, _F]),
    "qtpu_fleet_gather_masked": (ctypes.c_int, [
        ctypes.c_void_p, _F, ctypes.POINTER(ctypes.c_uint8)]),
    "qtpu_fleet_send": (ctypes.c_int, [ctypes.c_void_p, _F]),
    "qtpu_timer_create": (ctypes.c_void_p, [ctypes.c_double]),
    "qtpu_timer_destroy": (None, [ctypes.c_void_p]),
    "qtpu_timer_wait": (ctypes.c_double, [ctypes.c_void_p]),
    "qtpu_timer_max_jitter_us": (ctypes.c_double, [ctypes.c_void_p]),
    "qtpu_timer_mean_jitter_us": (ctypes.c_double, [ctypes.c_void_p]),
}


def build_native(force: bool = False):
    """Compile native/robot_bridge.cpp with g++ into the port's build
    directory (once per source; again with `force`). Returns the library
    path; raises with g++'s log on failure."""
    return host_build.build_host_library(force=force)[0]


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(str(build_native()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library_path():
    """The file the bindings load (under quadruped_tpu_torch/_build/)."""
    return host_build.library_path(host_build.BRIDGE_SOURCE, "qtpu_bridge")


def native_available() -> bool:
    """True when the library loads; False only where there is no g++ to
    build it. A failed build raises."""
    try:
        host_build.gxx_path()
    except RuntimeError:
        return False
    _load()
    return True


def _check_handle(handle, what: str):
    if not handle:
        raise RuntimeError(what)
    return handle


class RobotBridge:
    """UDP robot I/O with a wait-free latest-state snapshot.

    wire_mode="native" speaks the engine's 51/60-float protocol; "unitree"
    the Unitree LowState / LowCmd packets (891 / 730 bytes with the vendor
    CRC); "deeprobotics" the DeepRobotics EthCommand RobotState /
    RobotCmd packets (348 / 252 bytes). Vendor leg order is swapped inside
    the codec: the engine always sees FR, FL, RR, RL."""

    def __init__(self, recv_port: int, send_ip: str = "127.0.0.1",
                 send_port: int = 8008, torque_limit: float = 23.0,
                 wire_mode: str = "native"):
        lib = _load()
        self._lib = lib
        self._handle = _check_handle(lib.qtpu_bridge_create_wire(
            recv_port, send_ip.encode(), send_port,
            ctypes.c_float(torque_limit), WIRE_MODES[wire_mode]),
            f"failed to bind UDP port {recv_port}")
        self._state_buf = (ctypes.c_float * STATE_FLOATS)()

    def get_state(self):
        """Returns (packet_count, dict of state arrays)."""
        n = self._lib.qtpu_bridge_get_state(self._handle, self._state_buf)
        raw = np.frombuffer(self._state_buf, dtype=np.float32).copy()
        state = {
            "tick": raw[0],
            "quat": raw[1:5],
            "gyro": raw[5:8],
            "acc": raw[8:11],
            "q": raw[11:23],
            "dq": raw[23:35],
            "tau": raw[35:47],
            "foot_force": raw[47:51],
        }
        return int(n), state

    def send_command(self, q, kp, dq, kd, tau) -> bool:
        cmd = np.concatenate([np.asarray(x, np.float32).reshape(12)
                              for x in (q, kp, dq, kd, tau)])
        buf = (ctypes.c_float * COMMAND_FLOATS)(*cmd)
        return self._lib.qtpu_bridge_send_command(self._handle, buf) == 0

    def send_simple(self, code: int, value: int = 0) -> bool:
        """DeepRobotics control handshake (wire_mode='deeprobotics' only):
        a 12-byte single-value EthCommand, e.g. DR_CMD_TAKE_CONTROL before
        streaming joint commands, DR_CMD_RELEASE_CONTROL after."""
        return self._lib.qtpu_bridge_send_simple(self._handle, code,
                                                 value) == 0

    def close(self):
        if self._handle:
            self._lib.qtpu_bridge_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FleetBridge:
    """N-robot UDP multiplexer: hardware in the loop at fleet scale.

    Robots sit on consecutive ports (states received on base_recv_port + i,
    commands sent to base_send_port + i). A control tick makes two C
    calls whatever the fleet size: `gather()` fills one [n, 51] state batch
    and `send(commands)` fans a [n, 60] command batch out, torque-clipped
    per robot. `wire_mode` selects the codec as for RobotBridge."""

    def __init__(self, n: int, base_recv_port: int,
                 send_ip: str = "127.0.0.1", base_send_port: int = 8100,
                 torque_limit: float = 23.0, wire_mode: str = "native"):
        lib = _load()
        self._lib = lib
        self._n = n
        self._handle = _check_handle(lib.qtpu_fleet_create_wire(
            n, base_recv_port, send_ip.encode(), base_send_port,
            ctypes.c_float(torque_limit), WIRE_MODES[wire_mode]),
            f"failed to bind {n} UDP ports from {base_recv_port}")
        self._state_buf = (ctypes.c_float * (n * STATE_FLOATS))()
        self._live_buf = (ctypes.c_uint8 * n)()
        self._staged = {}     # device -> (rows, live, copy-done event)

    @property
    def n(self) -> int:
        return self._n

    def gather(self):
        """Returns (robots_with_data, states [n, 51] float32, live [n]).

        live[i] is 1.0 only once robot i has delivered a state packet; rows
        with live == 0 are all-zero filler (an invalid quaternion) and must
        be masked out before the batched controller reads them."""
        count = self._lib.qtpu_fleet_gather_masked(
            self._handle, self._state_buf, self._live_buf)
        states = np.frombuffer(self._state_buf, dtype=np.float32) \
            .reshape(self._n, STATE_FLOATS).copy()
        live = np.frombuffer(self._live_buf,
                             dtype=np.uint8).astype(np.float32).copy()
        return int(count), states, live

    def gather_tensor(self, device):
        """gather() into tensors on `device`: (robots_with_data, rows
        [n, 51] float32, live [n] float32). The native call writes straight
        into a host staging tensor, pinned when `device` is the card, and
        one copy takes it to the device (asynchronous there; the next
        gather waits for it before it writes the staging tensor again)."""
        device = torch.device(device)
        if device not in self._staged:
            pin = device.type == "cuda"
            rows = torch.empty(self._n, STATE_FLOATS, dtype=torch.float32,
                               pin_memory=pin)
            live = torch.empty(self._n, dtype=torch.uint8, pin_memory=pin)
            self._staged[device] = [rows, live, None]
        staged = self._staged[device]
        rows, live, done = staged
        if done is not None:
            done.synchronize()
        count = self._lib.qtpu_fleet_gather_masked(
            self._handle, ctypes.cast(rows.data_ptr(), _F),
            ctypes.cast(live.data_ptr(), ctypes.POINTER(ctypes.c_uint8)))
        if device.type == "cuda":
            out = (rows.to(device, non_blocking=True),
                   live.to(device, non_blocking=True).float())
            staged[2] = torch.cuda.Event()
            staged[2].record()
        else:
            out = rows.to(device, copy=True), live.to(device).float()
        return int(count), out[0], out[1]

    def send(self, commands) -> int:
        """commands: [n, 60] (q, kp, dq, kd, tau blocks of 12), numpy or a
        tensor. Returns how many robot sends succeeded."""
        if isinstance(commands, torch.Tensor):
            commands = commands.detach().cpu().numpy()
        cmd = np.ascontiguousarray(commands, np.float32) \
            .reshape(self._n * COMMAND_FLOATS)
        ptr = cmd.ctypes.data_as(_F)
        return self._lib.qtpu_fleet_send(self._handle, ptr)

    def close(self):
        if self._handle:
            self._lib.qtpu_fleet_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LoopTimer:
    """Absolute-deadline periodic timer (clock_nanosleep TIMER_ABSTIME)."""

    def __init__(self, frequency_hz: float):
        lib = _load()
        self._lib = lib
        self._handle = lib.qtpu_timer_create(frequency_hz)

    def wait(self) -> float:
        """Sleep to the next deadline; returns lateness in microseconds."""
        return self._lib.qtpu_timer_wait(self._handle)

    @property
    def max_jitter_us(self) -> float:
        return self._lib.qtpu_timer_max_jitter_us(self._handle)

    @property
    def mean_jitter_us(self) -> float:
        return self._lib.qtpu_timer_mean_jitter_us(self._handle)

    def close(self):
        if self._handle:
            self._lib.qtpu_timer_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
