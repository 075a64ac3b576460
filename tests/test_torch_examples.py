"""The port's examples on the SRB sim, the MPC examples and the bridge
(quadruped_tpu_torch/examples/) against the JAX examples (CPU).

Each example's `run(device="cpu")` at a short length (a1_trot 200 ticks,
aliengo_wbc_trot 100, fleet_sweep 60, keyboard_teleop two chunks of a
script, the bridge's dry run and 50 ticks of its UDP loop against a
loopback MCU in each wire mode) is held to the JAX example's loop on the
same inputs, kept in tests/data/examples_jax.npz because the card, where
no JAX is installed, holds its runs to the same traces (the `cuda` cases,
which also hold K1 to one launch a solve and the dense-QP kernel to one a
QP asked for). JAX still reproduces the fixture here, live. The limits are
those of the existing tests of the same loops, stated in
quadruped_tpu_torch/examples/fixture.py: the first 24 ticks of the SRB
MPC loops at tests/test_torch_rollout.py's, the whole run at 10x JAX's
own spread (its run from the base one float32 step up, in the fixture)
as the fleet fixture of benchmarks/fleet.py, except a1_trot's forces
(H=10), held over the run to fx.H10_FORCE_TOL = 1.75 N, set from
readings: the port reads 0.94 N here and 1.37 N on the card, and a fault
(example_a1_trot.config at 24 ADMM iterations in place of 40) reads
2.10 N and fails; the bridge's commands at test_torch_rollout.py's q /
dq and tests/test_torch_hil.py's torques.
CPU readings, port against JAX (limit): a1_trot heights 2.9e-5 m
(2.0e-4), velocities 8.5e-4 m/s (7.8e-3), forces 0.94 N (1.75); aliengo
heights 1.2e-5 m (2.4e-5), forces 0.77 N (4.2; 1.96 over the head);
fleet_sweep heights 7.9e-6 m (7.4e-5); keyboard_teleop positions 1.7e-5
m (5.4e-5); the bridge's torques 2.5e-3-4.0e-2 N m (0.3).

The fleet sweep also runs as two gloo processes, one half of the grid
each, against the one-process run. Beside them: each example's `main` at
a short length on the CPU writes
its files to the given paths and prints its lines and the report line;
without `--device` it raises here (no card), as every entry point of the
port does.

Regenerate the fixture (only when a JAX example changes on purpose):
    PYTHONPATH=. python tests/examples_jax.py
"""

import functools

import numpy as np
import pytest
import torch

import examples_jax as ej
from card_device import (DEVICES, assert_launches, count_qps,  # noqa: F401
                         launch_record, launches, on)
from quadruped_tpu_torch.examples import fixture as fx
from quadruped_tpu_torch.examples.fixture import wire_state_packet

torch.set_num_threads(1)

SRB = ("a1_trot", "aliengo_wbc_trot", "fleet_sweep", "keyboard_teleop")
ALL = ("a1_trot", "aliengo_wbc_trot", "fleet_sweep", "keyboard_teleop",
       "hardware_bridge", "whole_body_standup", "viz3d", "lite3_walk",
       "stair_climb", "gap_crossing")


@functools.lru_cache(maxsize=None)
def data():
    return np.load(fx.FIXTURE)


def port_run(name: str, device="cpu"):
    return (fx.bridge_dry_run(device) if name == "bridge_dry_run"
            else fx.short_run(name, device))


def assert_within(errs: dict):
    assert errs and not fx.over(errs), errs


def assert_solves(device, name, ticks, before, asked):
    """One MPC solve a batched solve tick (the boot's included); on the
    card, K1 once a solve and the dense-QP kernel once a QP asked for."""
    k1 = fx.k1_launches(name, ticks)
    assert asked["solves"] == k1
    if device != "cpu":
        assert_launches(before, asked, k1)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", SRB + ("bridge_dry_run",))
def test_example_matches_jax(name, device, monkeypatch):
    asked, before = count_qps(monkeypatch), launches()
    out = port_run(name, on(device))
    assert_within(fx.errors(name, out, data()))
    assert_solves(device, "hardware_bridge" if name == "bridge_dry_run"
                  else name, out["ticks"], before, asked)


JAX_RUNS = {"a1_trot": ej.a1_trot, "aliengo_wbc_trot": ej.aliengo_wbc_trot,
            "fleet_sweep": ej.fleet_sweep,
            "keyboard_teleop": ej.keyboard_teleop,
            "bridge_dry_run": ej.bridge_dry_run}


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_jax_reproduces_the_fixture(name):
    assert_within(fx.errors(name, JAX_RUNS[name](), data()))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("wire", fx.WIRES)
def test_bridge_loop_matches_jax(wire, device, monkeypatch):
    """50 ticks of the UDP loop against a loopback MCU streaming the wire's
    state packet: every tick read it, the MCU got one command a tick (and
    the DeepRobotics handshake and damping stream), the commands are the
    JAX loop's on the rows read (the fixture's, booted from the packet or
    from the empty snapshot)."""
    asked, before = count_qps(monkeypatch), launches()
    out = fx.bridge_run(wire, wire_state_packet(wire), on(device))
    errs, _ = fx.bridge_errors(wire, out, data())
    assert_within(errs)
    assert out["jitter_max_us"] >= out["jitter_mean_us"] >= 0.0
    assert_solves(device, "hardware_bridge", out["ticks"], before, asked)


def test_jax_bridge_loop_reproduces_the_fixture():
    rows = np.tile(data()["bridge_native/row"], (fx.BRIDGE_TICKS + 1, 1))
    got = ej.bridge_loop(rows)
    want = data()["bridge_native/boot_packet"]
    for j, key in enumerate(("q", "kp", "dq", "kd", "tau")):
        blk = slice(12 * j, 12 * j + 12)
        assert np.abs(got[:, blk] - want[:, blk]).max() \
            <= fx.COMMAND_TOL[key], key


MAINS = {
    "a1_trot": (["--steps", "20", "--out", "{tmp}/a1.png"], ["a1.png"],
                "summary:"),
    "aliengo_wbc_trot": (["--steps", "20"], [], "[MPC+WBC] alive=1"),
    "fleet_sweep": (["10"], [], "16 scenarios on 1 device(s)"),
    "keyboard_teleop": (["--script", "w x"], [], "scripted teleop:"),
    "hardware_bridge": (["--dry-run"], [], "dry run OK; tau[0:6] ="),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_on_the_cpu(name, tmp_path, capsys):
    args, files, line = MAINS[name]
    argv = [a.format(tmp=tmp_path) for a in args] + ["--device", "cpu"]
    assert fx.module(name).main(argv) == 0
    text = capsys.readouterr().out
    assert line in text, text
    assert "device: cpu; " in text and " ms a tick over " in text, text
    for f in files:
        assert (tmp_path / f).stat().st_size > 0, f


@pytest.mark.parametrize("name", ALL)
def test_main_without_a_card_raises(name):
    """No --device: the card, which this machine lacks."""
    args = {"hardware_bridge": ["--dry-run"],
            "keyboard_teleop": ["--script", "w"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fx.module(name).main(args)


def test_fleet_sweep_over_two_ranks(tmp_path):
    """The fleet sweep launched as two gloo processes (QTPU_* set, as
    tests/test_torch_distributed.py's workers; the example starts the
    group): each rank runs its 8 rows of the 16-scenario grid, and the
    rows, stitched, are held to the JAX fixture at the one-process run's
    limits and equal the one-process run's rows bit for bit."""
    from test_torch_distributed import _run_workers

    ticks = fx.SHORT["fleet_sweep"]["steps"]
    ranks = _run_workers("fleet", {"steps": np.array(ticks)}, tmp_path)
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert [int(r["devices"]) for r in ranks] == [2, 2]
    assert [int(r["first"]) for r in ranks] == [0, 8]
    keys = ("alive", "base_height_trace", "vel_trace")
    got = {k: np.concatenate([r[k] for r in ranks]) for k in keys}
    assert_within(fx.errors("fleet_sweep", got, data()))
    whole = port_run("fleet_sweep")
    for k in keys:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)


def test_fleet_sweep_refuses_an_uneven_split(monkeypatch):
    """16 scenarios over 3 ranks: ValueError, not the whole grid on every
    rank."""
    from quadruped_tpu_torch.benchmarks import fleet

    mod = fx.module("fleet_sweep")
    monkeypatch.setattr(mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mod.dist, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="split evenly over 3 ranks"):
        mod.shard(fleet.build(1, "cpu"), torch.device("cpu"))
