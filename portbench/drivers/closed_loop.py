"""What the sweep and tick drivers share: the program's closed loop built
from a configuration and its commands, and the reference following it from
the program's own state."""

from __future__ import annotations

import contextlib
import importlib

import torch

from portbench import check, generate, program, tree


def build(config: dict, traffic: dict, seed: int, device) -> dict:
    """The program's closed loop at t = 0, after its boot solve."""
    cfg, params = program.locomotion(config, device)
    cmds = generate.commands(traffic, config["robot"], seed, device)
    loop = program.rollout()
    carry = loop.rollout_init(cfg, params, traffic["batch"])
    return {"config": config, "traffic": traffic, "seed": seed,
            "device": device, "cfg": cfg, "params": params, "cmds": cmds,
            "cmd": program.command(cmds), "loop": loop, "carry": carry,
            "start": tree.clone(carry)}


def segment(state: dict, steps: int):
    """Advance the program's closed loop by `steps` ticks; returns the
    segment's RolloutResult."""
    state["carry"], res = state["loop"].rollout_segment(
        state["cfg"], state["params"], state["cmd"], state["carry"], steps)
    return res


def release(state: dict) -> None:
    """Drop the program's live state before the reference runs."""
    for key in ("carry", "cfg", "params", "cmd", "loop"):
        state.pop(key, None)
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def follow(state: dict, starts: list, ticks: int, tf32: bool = False):
    """The reference's boot and, from each program state in `starts` (handed
    over through a carry map, `tree.load`), its next `ticks` ticks: (init
    carry, [RolloutResult])."""
    ref = importlib.import_module(
        f"portbench.reference.{state['traffic']['reference']}")
    cfg, params = ref.build(state["config"], state["device"])
    cmd = ref.command(state["cmds"])
    ctx = check.tf32() if tf32 else contextlib.nullcontext()
    with ctx, torch.no_grad():
        init = ref.rollout_init(cfg, params, state["traffic"]["batch"])
        results = []
        for start in starts:
            carry, state["carry_map"] = tree.load(init, start)
            results.append(ref.rollout_segment(cfg, params, cmd, carry,
                                               ticks)[1])
    return init, results


def gaps(state: dict, program_out: list, starts: list, ticks: int,
         modes=("program",)) -> dict:
    """{mode: numbers}: for "program", the program's outputs against the
    reference's; for "control", the reference in TF32 against the
    reference. `program_out` holds, per start, a dict of the program's
    traces over the `ticks` ticks that followed (forces [B, K, 4, 3], tau
    [B, K, 12], height [B, K], vel [B, K, 3])."""
    mg = state["config"]["robot"]["total_mass"] * check.G
    init, ref = follow(state, starts, ticks)
    out = {}
    for mode in modes:
        if mode == "program":
            other_init, _ = tree.load(init, state["start"])
            other = program_out
        else:
            c_init, c_res = follow(state, starts, ticks, tf32=True)
            other_init = c_init
            other = [_traces(r) for r in c_res]
        refs = [_traces(r) for r in ref]
        out[mode] = {
            "boot_force_gap_mg": check.gap(
                other_init.ctrl.mpc.forces_world,
                init.ctrl.mpc.forces_world, mg),
            "force_gap_mg": max(check.gap(o["forces"], r["forces"], mg)
                                for o, r in zip(other, refs)),
            "torque_gap_nm": max(check.gap(o["tau"], r["tau"])
                                 for o, r in zip(other, refs)),
            "state_gap": max(max(check.gap(o["height"], r["height"]),
                                 check.gap(o["vel"], r["vel"]))
                             for o, r in zip(other, refs)),
        }
    return out


def _traces(res) -> dict:
    return {"forces": res.forces_trace, "tau": res.tau_trace,
            "height": res.base_height_trace, "vel": res.vel_trace}


def traces(res, ticks: int, device=None) -> dict:
    """The first `ticks` ticks of a program RolloutResult's traces, copied
    (to `device` where given)."""
    return {k: v[:, :ticks].to(device, copy=True)
            for k, v in _traces(res).items()}
