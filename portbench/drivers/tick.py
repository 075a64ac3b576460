"""One robot's closed loop, one tick at a time: each tick is a call of
`rollout_segment` for one tick that ends when the tick's command (stance
forces and feed-forward torques, with the sensed base height and
velocity) is on the host; the next tick starts when it has (a closed
loop).

End to end: tick_ms_p99, the 99th percentile over every tick of the window
of the tick's host time; its median and the tick count go to standard
error. Check: the reference's boot against the program's, and from the
program's state before `check_starts` ticks drawn from the seed among the
first `check_within` (the window runs on until they are done), the
reference's next `check_ticks` ticks against
the program's."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generate, tree
from portbench.drivers import closed_loop


def _tick(state: dict) -> torch.Tensor:
    res = closed_loop.segment(state, 1)
    return torch.cat([res.forces_trace.reshape(-1), res.tau_trace.reshape(-1),
                      res.base_height_trace.reshape(-1),
                      res.vel_trace.reshape(-1), res.alive.reshape(-1)]).cpu()


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    if traffic["batch"] != 1:
        raise ValueError("the tick driver runs one robot")
    state = closed_loop.build(config, traffic, seed, device)
    for _ in range(traffic["warmup_ticks"]):
        _tick(state)
    return state


def window(state: dict, seconds: float, tracer) -> dict:
    traffic = state["traffic"]
    k = traffic["check_ticks"]
    starts = set(generate.sample(traffic["check_within"],
                                 traffic["check_starts"], state["seed"]))
    due = max(starts) + k
    befores, times, outs = {}, [], []
    t0 = time.perf_counter()
    while True:
        i = len(times)
        if i in starts:
            befores[i] = tree.clone(state["carry"])
        ta = time.perf_counter()
        with tracer.unit():
            out = _tick(state)
        tb = time.perf_counter()
        times.append(tb - ta)
        outs.append(out)
        if tb - t0 >= seconds and len(times) >= due:
            break
    elapsed = time.perf_counter() - t0
    state["befores"] = {i: c for i, c in befores.items()
                        if i + k <= len(outs)}
    state["outs"] = torch.stack(outs)
    bad = ~torch.isfinite(state["outs"]).all(-1) | (state["outs"][:, -1] < 0.5)
    return {"elapsed_s": elapsed, "units": len(times), "ticks": len(times),
            "tick_s": np.asarray(times), "attempted": len(times),
            "failed": int(bad.sum())}


def end_to_end(state: dict, win: dict) -> dict:
    return {"tick_ms_p99": float(np.percentile(1e3 * win["tick_s"], 99))}


def work(state: dict, win: dict) -> dict:
    return {"ticks_per_unit": 1}


def lines(state: dict, win: dict) -> list:
    ms = 1e3 * win["tick_s"]
    return [f"tick: {len(ms)} ticks at B=1 in {win['elapsed_s']:.4f} s; "
            f"median {np.median(ms):.4f} ms, p99 {np.percentile(ms, 99):.4f}"
            f" ms, max {ms.max():.4f} ms"]


def check(state: dict, modes=("program",)) -> dict:
    closed_loop.release(state)
    k = state["traffic"]["check_ticks"]
    outs = state.pop("outs").to(state["device"])
    befores = state.pop("befores")
    picks = sorted(befores)
    program_out = []
    for i in picks:
        o = outs[i:i + k]                          # [K, 12 + 12 + 1 + 3 + 1]
        program_out.append({"forces": o[None, :, :12].reshape(1, k, 4, 3),
                            "tau": o[None, :, 12:24],
                            "height": o[None, :, 24],
                            "vel": o[None, :, 25:28]})
    return closed_loop.gaps(state, program_out, [befores[i] for i in picks],
                            k, modes)
