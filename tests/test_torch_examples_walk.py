"""The port's whole-body and walk examples (quadruped_tpu_torch/examples/)
against the JAX examples (CPU).

Each example's `run(device="cpu")` at a short length (whole_body_standup
200 ticks, viz3d 100, lite3_walk 150, stair_climb and gap_crossing 100) is
held to the JAX example's loop on the same inputs, kept in
tests/data/examples_jax.npz (the JAX compiles of these loops would take
most of this file's time; the `cuda` cases hold the card to the same
traces, K1 to one launch a solve and the dense-QP kernel to one a QP
asked for). The fixture also keeps each JAX run restarted from the base one
float32 step up (`nudged`), JAX's own spread. The limits, stated in
quadruped_tpu_torch/examples/fixture.py, are those of the existing tests
of the same loops: the whole-body trot test_torch_whole_body.py's
CLOSED_TOL; the runner test_torch_runner.py's rule (FSM states equal,
positions within 10x JAX's spread or 1e-5 m); the walks
test_torch_walk_windows.py's rule (sub-states equal, positions within 10x
JAX's spread or 1e-5 m, joint angles and attitude 10x or 1e-3 rad); the
contact flags at most FLAG_SLACK more flips than JAX's own spread. CPU
readings, port against JAX: the stand-up positions 6.1e-8 m; viz3d
8.0e-6 m, 1.7e-4 rad attitude, 1.2e-3 rad joints, contact equal; the
Lite3 walk 3.0e-8 m; the stair and gap walks 1.4e-4 m, 1.8e-3 rad joints.

Beside them: each example's `main` at a short length on the CPU writes
its files to the given paths and prints its lines and the report line.

Regenerate the fixture (only when a JAX example changes on purpose):
    PYTHONPATH=. python tests/examples_jax.py
"""

import functools

import numpy as np
import pytest
import torch

from card_device import (DEVICES, assert_launches, count_qps,  # noqa: F401
                         launch_record, launches, on)
from quadruped_tpu_torch.examples import fixture as fx

torch.set_num_threads(1)

WALKS = ("whole_body_standup", "viz3d", "lite3_walk", "stair_climb",
         "gap_crossing")


@functools.lru_cache(maxsize=None)
def data():
    return np.load(fx.FIXTURE)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", WALKS)
def test_example_matches_jax(name, device, monkeypatch):
    asked, before = count_qps(monkeypatch), launches()
    out = fx.short_run(name, on(device))
    errs = fx.errors(name, out, data())
    assert errs and not fx.over(errs), errs
    k1 = fx.k1_launches(name, out["ticks"])
    assert asked["solves"] == k1
    if device != "cpu":
        assert_launches(before, asked, k1)


def test_nudged_runs_spread():
    """JAX's own spread is there to hold the port to: each nudged run
    moves, and stays on its sub-states and FSM states."""
    d = data()
    for name in WALKS:
        assert np.abs(d[f"{name}/nudged/position"]
                      - d[f"{name}/position"]).max() > 0, name
        for key in ("sub_state", "fsm"):
            if f"{name}/{key}" in d.files:
                np.testing.assert_array_equal(d[f"{name}/nudged/{key}"],
                                              d[f"{name}/{key}"])


MAINS = {
    "whole_body_standup": (["20"], [], "t= 0.00s fsm="),
    "viz3d": (["{tmp}/trot.gif", "20"], ["trot.gif", "trot.png"],
              "wrote "),
    "lite3_walk": (["--steps", "5"], [], "max simultaneous swings:"),
    "stair_climb": (["{tmp}/stairs.gif", "0.02"], ["stairs.gif",
                                                   "stairs.png"], "climb: x"),
    "gap_crossing": (["{tmp}/gap.gif", "0.02"], ["gap.gif", "gap.png"],
                     "crossing: x"),
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
