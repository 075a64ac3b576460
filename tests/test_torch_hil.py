"""The port's hardware-in-the-loop tick (quadruped_tpu_torch/benchmarks/
hil_latency.py) on the CPU, at fleets of 1 and 2, over UDP loopback.

Six timed ticks through the whole path (the feeder thread, the port's
FleetBridge, `obs_from_rows`, `locomotion_step`, the command fetch,
`FleetBridge.send`):
* every robot's sink receives one command a tick, and it equals the
  port's tick replayed on the rows the bridge gathered, with the bridge's
  23 N m torque clip, bit for bit;
* the forces and torques equal the JAX script's tick (`jax.vmap` of the
  JAX `locomotion_step` on the JAX `obs_from_rows`, booted by the JAX
  `locomotion_init`) on the same rows, within tests/test_torch_rollout.py's
  1% m*g (forces) and TAU_TOL;
* the cadence run solves on its first tick only (one in 8), the
  `solve_mode="always"` run on every tick, and the summary splits solve and
  hold ticks.
"""

import functools

import numpy as np
import pytest
import torch

from card_device import cuda_device  # noqa: F401
from quadruped_tpu_torch.benchmarks import hil_latency as hil

torch.set_num_threads(1)

TICKS = 6
MG = 13.0 * 9.81
FORCE_TOL = 0.01 * MG
TAU_TOL = 0.3     # N m (the WBC tests' torque limit)


@functools.lru_cache(maxsize=None)
def _jax_tick(n: int):
    """The JAX script's tick (benchmarks/hil_latency.py build_tick, on the
    CPU): (jitted tick, booted controller)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc as mpc_mod, swing as swing_mod
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import (LocomotionConfig,
                                                  locomotion_init,
                                                  locomotion_step)
    from quadruped_tpu.control.types import RobotObservation
    from quadruped_tpu.core import se3
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import a1_params

    params = a1_params()
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=0.2, body_height=0.27)

    def obs_from_rows(rows):
        quat = rows[:, 1:5]
        r = jax.vmap(se3.quat_to_rotmat)(quat)
        omega = rows[:, 5:8]
        return RobotObservation(
            base_position=jnp.tile(jnp.asarray([0.0, 0.0, 0.27]), (n, 1)),
            base_rpy=jax.vmap(se3.quat_to_rpy)(quat), base_quat=quat,
            base_vel_world=jnp.zeros((n, 3)),
            base_omega_world=jnp.einsum("bij,bj->bi", r, omega),
            base_omega_body=omega, joint_angles=rows[:, 11:23],
            joint_velocities=rows[:, 23:35],
            foot_contact=(rows[:, 47:51] > 5.0).astype(jnp.float32),
            foot_forces=rows[:, 47:51])

    ctrl0 = jax.jit(jax.vmap(lambda o: locomotion_init(config, params, o)))(
        obs_from_rows(jnp.asarray(hil.boot_rows(n))))

    @jax.jit
    def tick(ctrl, rows, t):
        command, forces, ctrl = jax.vmap(
            lambda c, o: locomotion_step(config, params, c, o, cmd, t)
        )(ctrl, obs_from_rows(rows))
        return ctrl, command.tau, forces

    return tick, ctrl0


@pytest.mark.parametrize("n", [1, 2])
def test_hil_tick_commands_and_jax(n):
    import jax.numpy as jnp

    with hil.HilRig(n, "cpu") as rig:
        res = rig.run(TICKS, record=True)
        ctrl0 = rig.ctrl0
        cfg, params, cmd = rig.config, rig.params, rig.cmd
    assert (res["received"] == 1).all()
    assert res["solve"].tolist() == [True] + [False] * (TICKS - 1)
    assert res["k1"].sum() == 0            # the CPU runs K1's plain version

    ctrl = ctrl0
    jtick, jctrl = _jax_tick(n)
    t = hil.T_START
    for k in range(TICKS):
        rows = torch.from_numpy(res["rows"][k])
        ctrl, command, forces = hil.tick(cfg, params, cmd, ctrl, rows, t)
        sent = command.numpy().copy()
        sent[:, 48:] = np.clip(sent[:, 48:], -23.0, 23.0)
        np.testing.assert_array_equal(res["commands"][k], command.numpy())
        np.testing.assert_array_equal(np.stack(res["packets"][k]), sent)
        np.testing.assert_array_equal(res["forces"][k], forces.numpy())
        jctrl, jtau, jforces = jtick(jctrl, jnp.asarray(res["rows"][k]),
                                     jnp.float32(t))
        assert np.abs(forces.numpy() - np.asarray(jforces)).max() \
            <= FORCE_TOL, k
        assert np.abs(command[:, 48:].numpy() - np.asarray(jtau)).max() \
            <= TAU_TOL, k
        t += hil.DT


def test_hil_always_solves_and_summary():
    with hil.HilRig(1, "cpu", solve_mode="always") as rig:
        res = rig.run(3)
    assert res["solve"].all() and (res["received"] == 1).all()
    s = hil.summarize(res)
    assert s["solve_ticks"]["ticks"] == 3 and s["hold_ticks"] == {"ticks": 0}
    assert s["all_ticks"]["p50_ms"] > 0
    assert set(s) >= {"within_2ms_tick_budget", "within_15ms_cadence_budget"}


# (fleet size, solve mode, ticks): a fleet of 2, and the hil benchmark's
# fleets of 1 and 16 over its 300 ticks in each mode.
CARD_CASES = [(2, "cadence", 10)] + [(n, mode, 300) for n in (1, 16)
                                     for mode in hil.MODES]


@pytest.mark.cuda
@pytest.mark.parametrize("n,mode,ticks", CARD_CASES,
                         ids=[f"b{n}-{mode}-{t}" for n, mode, t in CARD_CASES])
def test_hil_tick_on_the_card(cuda_device, n, mode, ticks):
    """On the card: the rows reach the device through the pinned staging
    buffer, K1 launches once on each solve tick (one in 8 at the cadence,
    every tick with `solve_mode="always"`) and never on a hold tick,
    every command is finite and every sink served every tick."""
    from quadruped_tpu_torch.solvers import fused_admm

    with hil.HilRig(n, cuda_device, solve_mode=mode) as rig:
        count, rows, live = rig.fleet.gather_tensor(cuda_device)
        assert count == n and rows.is_cuda and live.is_cuda
        assert rig.fleet._staged[cuda_device][0].is_pinned()
        before = fused_admm.fused_admm.launches
        res = rig.run(ticks, warmup=0, record=True)
        launches = fused_admm.fused_admm.launches - before
    assert (res["received"] == 1).all()
    assert np.isfinite(res["commands"]).all()
    solves = ticks if mode == "always" else -(-ticks // 8)
    assert (res["k1"] == res["solve"]).all() and res["solve"].sum() == solves
    assert launches == solves


def _round_trip(mode: str) -> None:
    """One loopback round trip through the port's RobotBridge in `mode`:
    the joint angles decoded from a packet written at the spec offsets,
    and the command's joint targets and torques (50 N m asked) clipped to
    the 23 N m limit on the wire."""
    import socket
    import struct
    import time

    from quadruped_tpu_torch.examples.fixture import (_crc32_unitree,
                                                      wire_state_packet)
    from quadruped_tpu_torch.runtime import RobotBridge

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        state_port = probe.getsockname()[1]
    mcu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mcu.bind(("127.0.0.1", 0))
    mcu.settimeout(2.0)
    bridge = RobotBridge(recv_port=state_port,
                         send_port=mcu.getsockname()[1], torque_limit=23.0,
                         wire_mode=mode)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        pkt = wire_state_packet(mode)
        deadline, n = time.time() + 2.0, 0
        while n == 0 and time.time() < deadline:
            tx.sendto(pkt, ("127.0.0.1", state_port))
            time.sleep(0.01)
            n, state = bridge.get_state()
        assert n, f"{mode}: no state decoded"
        j = np.arange(12)
        wire = j + 3 - 6 * ((j // 3) % 2)      # FR<->FL, RR<->RL swaps
        want_q = 1.0 + 0.01 * wire if mode == "deeprobotics" \
            else 0.3 + 0.01 * j
        assert np.abs(state["q"] - want_q).max() < 1e-5
        q = 0.1 * j
        assert bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.full(12, 50.0))
        data, _ = mcu.recvfrom(4096)
        if mode == "native":
            cmd = np.frombuffer(data, np.float32)
            q_sent, tau = cmd[:12], cmd[48:60]
        else:
            if mode == "unitree":
                assert struct.unpack_from("<I", data, 726)[0] \
                    == _crc32_unitree(data)
                at = [11 + 33 * k for k in range(12)]
            else:
                at = [12 + 20 * int(w) for w in wire]
            rows = [struct.unpack_from("<5f", data, a) for a in at]
            q_sent = np.array([r[0] for r in rows])
            tau = np.array([r[2] for r in rows])
        assert np.abs(q_sent - q).max() < 1e-6
        assert np.all(tau == np.float32(23.0))
    finally:
        bridge.close()
        mcu.close()
        tx.close()


@pytest.mark.cuda
def test_bridge_on_the_card_machine(cuda_device):
    """The host library built from native/robot_bridge.cpp with g++ into
    quadruped_tpu_torch/_build/ (native/libqtpu_bridge.so left as it was),
    then one loopback round trip per wire mode."""
    from pathlib import Path

    from quadruped_tpu_torch.utils import host_build

    root = Path(__file__).resolve().parents[1]
    jax_so = root / "native" / "libqtpu_bridge.so"
    before = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    path, _, _ = host_build.build_host_library(force=True)
    assert path.parent == root / "quadruped_tpu_torch" / "_build"
    assert (jax_so.stat().st_mtime_ns if jax_so.exists() else None) == before
    for mode in ("native", "unitree", "deeprobotics"):
        _round_trip(mode)
