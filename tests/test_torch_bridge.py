"""The port's host bridge (quadruped_tpu_torch/runtime/bridge.py) over UDP
loopback, against the JAX package's bridge (CPU, no card).

Mirrors tests/test_native_bridge.py, test_unitree_wire.py and
test_deeprobotics_wire.py on the port's own build of
native/robot_bridge.cpp (under quadruped_tpu_torch/_build/), and feeds the
same packets to the port's RobotBridge and the JAX one: the decoded states
are equal and the command bytes on the wire are equal, in every wire mode.
Every port is taken from the OS (the JAX tests bind fixed ports such as
39011 and may run at the same time in another worker).
"""

import socket
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.runtime import bridge as tb
from test_deeprobotics_wire import (CMD_PACKET_BYTES, CODE_ROBOT_CMD,
                                    make_robot_state, rpy_to_quat_np)
from test_unitree_wire import LOWCMD_BYTES, crc32_unitree, make_lowstate

ROOT = Path(__file__).resolve().parents[1]


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mcu():
    """A bound socket playing the robot's MCU; returns (socket, port)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(2.0)
    return s, s.getsockname()[1]


def _consecutive_sinks(n: int, tries: int = 50):
    """n sockets bound to consecutive ports from an OS-given one; returns
    (base port, sockets)."""
    for _ in range(tries):
        base = _free_udp_port()
        socks = []
        try:
            for i in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
                s.settimeout(2.0)
            return base, socks
        except OSError:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free UDP ports")


def make_state_packet(tick, q_fill=0.5):
    vals = np.zeros(tb.STATE_FLOATS, np.float32)
    vals[0] = tick
    vals[1] = 1.0
    vals[11:23] = q_fill
    vals[47:51] = 30.0
    return vals.tobytes()


PACKETS = {"native": lambda: make_state_packet(5, q_fill=0.5),
           "unitree": make_lowstate,
           "deeprobotics": make_robot_state}


def _wait_state(bridge, tx, pkt, port):
    deadline = time.time() + 2.0
    n, state = 0, None
    while time.time() < deadline:
        tx.sendto(pkt, ("127.0.0.1", port))
        n, state = bridge.get_state()
        if n > 0:
            break
        time.sleep(0.02)
    assert n > 0, "no state packet decoded"
    return n, state


def test_library_built_under_the_port_build_dir(monkeypatch):
    """The port loads its own build, under quadruped_tpu_torch/_build/: a
    forced rebuild runs g++ on native/robot_bridge.cpp with the JAX
    package's flags into a temporary file there, and names
    native/libqtpu_bridge.so nowhere."""
    import subprocess

    calls = []
    run = subprocess.run
    monkeypatch.setattr(tb.host_build.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or run(cmd, **kw))
    path, _, seconds = tb.host_build.build_host_library(force=True)
    assert len(calls) == 1 and seconds > 0
    cmd = calls[0]
    out = Path(cmd[cmd.index("-o") + 1])
    assert out.parent == ROOT / "quadruped_tpu_torch" / "_build"
    assert str(ROOT / "native" / "robot_bridge.cpp") in cmd
    assert {"-O2", "-shared", "-fPIC", "-std=c++17", "-lpthread"} <= set(cmd)
    assert not any("libqtpu_bridge.so" in str(a) for a in cmd)
    assert path.parent == out.parent and path == tb.library_path()
    assert path.exists() and not out.exists()     # moved into place
    assert tb.native_available()
    assert Path(tb._load()._name) == path


def test_failed_build_raises_with_the_log(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tb.host_build.build_host_library(bad, "bad_test", force=True)


@pytest.mark.parametrize("wire_mode", list(tb.WIRE_MODES))
def test_same_packets_same_states_and_bytes_as_jax(wire_mode):
    """The port's bridge and the JAX one, each fed the same state packet
    and asked for the same command: equal decoded states, equal bytes on
    the wire (the torque clip at 23 N m included)."""
    from quadruped_tpu.runtime.bridge import RobotBridge as JaxBridge

    pkt = PACKETS[wire_mode]()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    got = {}
    for side, cls in (("port", tb.RobotBridge), ("jax", JaxBridge)):
        mcu, cmd_port = _mcu()
        state_port = _free_udp_port()
        bridge = cls(recv_port=state_port, send_port=cmd_port,
                     torque_limit=23.0, wire_mode=wire_mode)
        try:
            _, state = _wait_state(bridge, tx, pkt, state_port)
            assert bridge.send_command(0.1 * np.arange(12),
                                       np.full(12, 60.0), np.zeros(12),
                                       np.full(12, 5.0), np.full(12, 50.0))
            data, _ = mcu.recvfrom(4096)
            got[side] = (state, data)
        finally:
            bridge.close()
            mcu.close()
    tx.close()
    for key, value in got["jax"][0].items():
        np.testing.assert_array_equal(got["port"][0][key], value,
                                      err_msg=key)
    assert got["port"][1] == got["jax"][1]


def test_state_roundtrip_and_command_clip():
    mcu, cmd_port = _mcu()
    state_port = _free_udp_port()
    bridge = tb.RobotBridge(recv_port=state_port, send_ip="127.0.0.1",
                            send_port=cmd_port, torque_limit=23.0)
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(5):
            tx.sendto(make_state_packet(i + 1, q_fill=0.1 * (i + 1)),
                      ("127.0.0.1", state_port))
            time.sleep(0.01)
        deadline = time.time() + 2.0
        n = 0
        while time.time() < deadline:
            n, state = bridge.get_state()
            if n >= 5:
                break
            time.sleep(0.01)
        assert n >= 5, "receiver thread did not deliver packets"
        np.testing.assert_allclose(state["tick"], 5.0)
        np.testing.assert_allclose(state["q"], 0.5, atol=1e-6)
        np.testing.assert_allclose(state["foot_force"], 30.0)
        assert bridge.send_command(
            q=np.ones(12) * 0.3, kp=np.full(12, 100.0), dq=np.zeros(12),
            kd=np.full(12, 2.0), tau=np.full(12, 99.0))
        cmd = np.frombuffer(mcu.recvfrom(4096)[0], np.float32)
        assert cmd.shape == (60,)
        np.testing.assert_allclose(cmd[0:12], 0.3, atol=1e-6)
        np.testing.assert_allclose(cmd[48:60], 23.0)
    finally:
        bridge.close()
        mcu.close()


def test_loop_timer_rate_and_jitter():
    timer = tb.LoopTimer(frequency_hz=1000.0)
    try:
        t0 = time.perf_counter()
        for _ in range(200):
            timer.wait()
        elapsed = time.perf_counter() - t0
        assert 0.15 < elapsed < 0.5
        assert timer.mean_jitter_us < 2000.0
        assert timer.max_jitter_us >= timer.mean_jitter_us
    finally:
        timer.close()


def test_fleet_gather_fanout_and_gather_tensor():
    n = 3
    base_cmd, mcus = _consecutive_sinks(n)
    base_state, probe = _consecutive_sinks(n)
    for s in probe:
        s.close()
    fleet = tb.FleetBridge(n, base_recv_port=base_state,
                           base_send_port=base_cmd, torque_limit=23.0)
    try:
        assert fleet.n == n
        count, rows, live = fleet.gather_tensor("cpu")
        assert count == 0 and float(live.sum()) == 0.0
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(n):
            tx.sendto(make_state_packet(i + 1, q_fill=0.1 * (i + 1)),
                      ("127.0.0.1", base_state + i))
        deadline = time.time() + 2.0
        count = 0
        while time.time() < deadline:
            count, states, mask = fleet.gather()
            if count >= n:
                break
            time.sleep(0.01)
        assert count == n, "not all fleet receivers delivered"
        assert states.shape == (n, tb.STATE_FLOATS)
        np.testing.assert_allclose(mask, 1.0)
        np.testing.assert_allclose(states[:, 0], [1.0, 2.0, 3.0])
        np.testing.assert_allclose(states[1, 11:23], 0.2, atol=1e-6)
        # The tensor form: the same rows and mask, its own storage.
        count_t, rows, live = fleet.gather_tensor("cpu")
        assert count_t == n and rows.dtype == torch.float32
        np.testing.assert_array_equal(rows.numpy(), states)
        np.testing.assert_array_equal(live.numpy(), mask)
        assert rows.data_ptr() != fleet._staged[torch.device("cpu")][0] \
            .data_ptr()

        cmds = np.zeros((n, 60), np.float32)
        for i in range(n):
            cmds[i, 0:12] = 0.1 * (i + 1)
            cmds[i, 48:60] = 50.0 + i
        assert fleet.send(torch.from_numpy(cmds)) == n
        for i in range(n):
            got = np.frombuffer(mcus[i].recvfrom(4096)[0], np.float32)
            np.testing.assert_allclose(got[0:12], 0.1 * (i + 1), atol=1e-6)
            np.testing.assert_allclose(got[48:60], 23.0)
    finally:
        fleet.close()
        for s in mcus:
            s.close()


def test_unitree_lowstate_decode_and_lowcmd_encode():
    mcu, cmd_port = _mcu()
    state_port = _free_udp_port()
    bridge = tb.RobotBridge(recv_port=state_port, send_port=cmd_port,
                            torque_limit=23.0, wire_mode="unitree")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        _, state = _wait_state(bridge, tx, make_lowstate(), state_port)
        np.testing.assert_allclose(state["tick"], 0.123456, rtol=1e-5)
        np.testing.assert_allclose(state["quat"], [1, 0, 0, 0])
        np.testing.assert_allclose(state["q"], 0.3 + 0.01 * np.arange(12),
                                   rtol=1e-5)
        np.testing.assert_allclose(state["tau"], 2.0 + 0.1 * np.arange(12),
                                   rtol=1e-5)
        np.testing.assert_allclose(state["foot_force"], [10, 20, 30, 40])
        q = 0.1 * np.arange(12)
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.full(12, 50.0))
        data, _ = mcu.recvfrom(4096)
        assert len(data) == LOWCMD_BYTES and data[0] == 0xFF
        assert struct.unpack_from("<I", data, LOWCMD_BYTES - 4)[0] \
            == crc32_unitree(data)
        for j in range(12):
            qj, _, tauj, kpj, kdj = struct.unpack_from("<5f", data,
                                                       10 + 33 * j + 1)
            np.testing.assert_allclose([qj, tauj, kpj, kdj],
                                       [q[j], 23.0, 60.0, 5.0], rtol=1e-6)
    finally:
        bridge.close()
        mcu.close()


@pytest.mark.parametrize("wire_mode", ["unitree", "deeprobotics"])
def test_corrupted_packets_dropped(wire_mode):
    state_port = _free_udp_port()
    bridge = tb.RobotBridge(recv_port=state_port,
                            send_port=_free_udp_port(), wire_mode=wire_mode)
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if wire_mode == "unitree":
            bad = bytearray(make_lowstate())
            bad[100] ^= 0xFF
            packets = [bytes(bad), make_lowstate()[:500]]
        else:
            good = make_robot_state()
            packets = [struct.pack("<I", 0x0907) + good[4:],
                       good[:4] + struct.pack("<I", 100) + good[8:],
                       good[:8] + struct.pack("<I", 0 | (7 << 8)) + good[12:],
                       good[:100]]
        for p in packets:
            for _ in range(3):
                tx.sendto(p, ("127.0.0.1", state_port))
        time.sleep(0.2)
        n, _ = bridge.get_state()
        assert n == 0, "corrupted / malformed packets must be dropped"
    finally:
        bridge.close()


def test_deeprobotics_decode_encode_and_handshake():
    mcu, cmd_port = _mcu()
    state_port = _free_udp_port()
    bridge = tb.RobotBridge(recv_port=state_port, send_port=cmd_port,
                            torque_limit=23.0, wire_mode="deeprobotics")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        _, state = _wait_state(bridge, tx, make_robot_state(), state_port)
        np.testing.assert_allclose(state["tick"], 2.5, rtol=1e-6)
        np.testing.assert_allclose(
            state["quat"], rpy_to_quat_np(np.deg2rad([2.0, -3.0, 10.0])),
            rtol=1e-5, atol=1e-6)
        wire_of_engine = np.asarray(
            [j + 3 if (j // 3) % 2 == 0 else j - 3 for j in range(12)])
        np.testing.assert_allclose(state["q"], 1.0 + 0.01 * wire_of_engine,
                                   rtol=1e-5)
        np.testing.assert_allclose(state["foot_force"],
                                   [11.0, 10.0, 13.0, 12.0])
        q = 0.1 * np.arange(12)
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.full(12, 50.0))
        data, _ = mcu.recvfrom(4096)
        assert len(data) == CMD_PACKET_BYTES
        code, size, word2 = struct.unpack_from("<III", data, 0)
        assert (code, size, word2 & 0xFF) == (CODE_ROBOT_CMD, 240, 1)
        for ej in range(12):
            pos, _, tor, kp, kd = struct.unpack_from(
                "<5f", data, 12 + 20 * int(wire_of_engine[ej]))
            np.testing.assert_allclose([pos, tor, kp, kd],
                                       [q[ej], 23.0, 60.0, 5.0],
                                       rtol=1e-6, atol=1e-7)
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.zeros(12))
        data2, _ = mcu.recvfrom(4096)
        assert (struct.unpack_from("<I", data2, 8)[0] >> 8) \
            == ((word2 >> 8) + 1) & 0xFFFFFF
        for code in (tb.DR_CMD_TAKE_CONTROL, tb.DR_CMD_RELEASE_CONTROL):
            assert bridge.send_simple(code)
            hs, _ = mcu.recvfrom(4096)
            assert struct.unpack("<III", hs)[0] == code
            assert struct.unpack("<III", hs)[2] & 0xFF == 0
    finally:
        bridge.close()
        mcu.close()


def test_deeprobotics_fleet():
    base_cmd, mcus = _consecutive_sinks(2)
    base_state = _free_udp_port()
    fleet = tb.FleetBridge(2, base_recv_port=base_state,
                           base_send_port=base_cmd, wire_mode="deeprobotics")
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        deadline = time.time() + 2.0
        count = 0
        while time.time() < deadline:
            for i in range(2):
                tx.sendto(make_robot_state(tick_ms=1000 + i),
                          ("127.0.0.1", base_state + i))
            count, states, live = fleet.gather()
            if count == 2:
                break
            time.sleep(0.02)
        assert count == 2 and (live == 1.0).all()
        np.testing.assert_allclose(states[:, 0], [1.000, 1.001], rtol=1e-6)
        cmds = np.zeros((2, 60), np.float32)
        cmds[:, :12] = 0.2
        assert fleet.send(cmds) == 2
        for s in mcus:
            data, _ = s.recvfrom(4096)
            assert len(data) == CMD_PACKET_BYTES
            assert struct.unpack_from("<I", data, 0)[0] == CODE_ROBOT_CMD
    finally:
        fleet.close()
        for s in mcus:
            s.close()

