"""Batched MPC updates: the port's `bench.build_bench(B, route, H)` update
(trajectory build, SRB matrices, ZOH, condensation, cone build and the
warm-started solve) over a ring of cadence problems made on the device from
the seed (`generate.cadence_ring`); each update takes the next problem and
starts from the previous update's solution.

End to end: solves_per_s = updates x B over the window's wall time, the
window ending in a synchronize. Check: for `check_updates` updates drawn
from the seed among the first `check_within` (the window runs on until they are
done) and the window's last, the
reference's update of the same problem from the same warm start against
the program's solution."""

from __future__ import annotations

import time

import torch

from portbench import check as check_mod
from portbench import generate, program


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    b = traffic["batch"]
    horizon = config["mpc"]["horizon"]
    fn, args, _ = program.bench().build_bench(b, traffic["route"], horizon,
                                              device=device)
    ring = generate.cadence_ring(dict(traffic, horizon=horizon), seed,
                                 device)
    state = {"config": config, "traffic": traffic, "seed": seed,
             "device": device, "fn": fn, "ring": ring, "k": 0,
             "xy": (args[4], args[5])}
    for _ in range(traffic["warmup_updates"]):
        _step(state)
    _sync(device)
    return state


def _problem(state: dict, k: int) -> tuple:
    r = state["ring"]
    return r["rpy"][k], r["feet"][k], r["x0"][k], r["contact"][k]


def _step(state: dict) -> int:
    k = state["k"] % state["traffic"]["ring"]
    state["xy"] = state["fn"](*_problem(state, k), *state["xy"])
    state["k"] += 1
    return k


def window(state: dict, seconds: float, tracer) -> dict:
    traffic = state["traffic"]
    picks = set(generate.sample(traffic["check_within"],
                                traffic["check_updates"] - 1, state["seed"]))
    due = traffic["check_within"]
    kept, failed, updates = [], None, 0
    t0 = time.perf_counter()
    while True:
        warm = tuple(v.clone() for v in state["xy"])
        with tracer.unit():
            k = _step(state)
        last = (k, warm, tuple(v.clone() for v in state["xy"]))
        if updates in picks:
            kept.append(last)
        bad = (~torch.isfinite(state["xy"][0]).all(-1)).sum()
        failed = bad if failed is None else failed + bad
        updates += 1
        if time.perf_counter() - t0 >= seconds and updates >= due:
            break
    _sync(state["device"])
    elapsed = time.perf_counter() - t0
    if updates - 1 not in picks:
        kept.append(last)
    state["kept"] = kept
    b = traffic["batch"]
    return {"elapsed_s": elapsed, "units": updates, "updates": updates,
            "attempted": b * updates, "failed": int(failed)}


def end_to_end(state: dict, win: dict) -> dict:
    return {"solves_per_s": state["traffic"]["batch"] * win["updates"]
            / win["elapsed_s"]}


def work(state: dict, win: dict) -> dict:
    mpc = state["config"]["mpc"]
    return {"admm_shape": (state["traffic"]["batch"], 12 * mpc["horizon"],
                           mpc["qp_iters"])}


def lines(state: dict, win: dict) -> list:
    return [f"update: {win['updates']} updates at B="
            f"{state['traffic']['batch']} in {win['elapsed_s']:.4f} s, "
            f"{1e3 * win['elapsed_s'] / win['updates']:.4f} ms an update"]


def check(state: dict, modes=("program",)) -> dict:
    from portbench.reference import update as ref
    for key in ("fn", "xy"):
        state.pop(key)
    device = state["device"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, params = ref.build(state["config"], device)
    mg = state["config"]["robot"]["total_mass"] * check_mod.G
    out = {mode: {"force_gap_mg": 0.0} for mode in modes}
    with torch.no_grad():
        for k, warm, solved in state.pop("kept"):
            x_ref, _ = ref.update(cfg, params, *_problem(state, k), *warm)
            if "program" in modes:
                g = check_mod.gap(solved[0], x_ref, mg)
                out["program"]["force_gap_mg"] = max(
                    out["program"]["force_gap_mg"], g)
            if "control" in modes:
                with check_mod.tf32():
                    x_c, _ = ref.update(cfg, params, *_problem(state, k),
                                        *warm)
                out["control"]["force_gap_mg"] = max(
                    out["control"]["force_gap_mg"],
                    check_mod.gap(x_c, x_ref, mg))
    return out
