"""The check sees faults in the timed path: each run here drives the whole
harness on the CPU (no look for a card) with the program broken
underneath, and `correct` has to come out false. The faults a cell can
have: a step that returns its state unchanged, half of the batch left out
(the rest's mean in its place), and an answer altered where it is
produced. The tick cell runs one robot, so it has no half batch."""

import dataclasses

import pytest
import torch

from portbench import harness
from portbench.tests.cases import small

# The closed-loop cells of BENCHMARK.json (sweep and tick drivers).
ROLLOUT_CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]
    if harness.cell_files(w["name"])["traffic"]["driver"] in ("sweep", "tick")]


def _run(name):
    return harness.rehearse(name, seed=2 ** 31 + 23, seconds=0.3,
                            overrides=small(name))


def _half(v: torch.Tensor) -> torch.Tensor:
    b = v.shape[0]
    out = v.clone()
    out[b // 2:] = v[:b // 2].mean(0, keepdim=True)
    return out


def _closed_loop_fault(monkeypatch, fault):
    from quadruped_tpu_torch.sim import rollout, srb_sim
    if fault == "state_unchanged":
        monkeypatch.setattr(srb_sim, "srb_sim_step",
                            lambda params, state, *a, **k: state)
        return
    step = rollout.locomotion_step

    def broken(*args, **kwargs):
        command, forces, state = step(*args, **kwargs)
        if fault == "half_batch":
            forces = _half(forces)
            command = dataclasses.replace(command, tau=_half(command.tau))
        else:
            forces = forces.clone()
            forces[:, 0, 2] *= 1.01
        return command, forces, state

    monkeypatch.setattr(rollout, "locomotion_step", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ROLLOUT_CELLS)
def test_closed_loop_fault_is_caught(monkeypatch, name, fault):
    if fault == "half_batch" and small(name).get("batch", 1) == 1:
        pytest.skip("one robot: no half of the batch to leave out")
    _closed_loop_fault(monkeypatch, fault)
    r = _run(name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_update_fault_is_caught(monkeypatch, fault):
    from quadruped_tpu_torch.solvers import cone_qp
    solve = cone_qp.solve

    def broken(prob, **kw):
        sol = solve(prob, **kw)
        if kw.get("iters") != 24:           # the boot is not the timed path
            return sol
        if fault == "state_unchanged":
            return dataclasses.replace(sol, x=kw["x0"], y=kw["y0"])
        if fault == "half_batch":
            return dataclasses.replace(sol, x=_half(sol.x))
        x = sol.x.clone()
        x[:, 2] *= 1.01
        return dataclasses.replace(sol, x=x)

    monkeypatch.setattr(cone_qp, "solve", broken)
    r = _run("a1-h10.update-b8192")
    assert r["correct"] is False, r["checks"]
