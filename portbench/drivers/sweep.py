"""A batched sweep: the closed loop of B scenarios (`sim.rollout`) driven
in segments of `segment_ticks` ticks until the window's seconds are spent;
the window may end up to one segment late and its rate counts that time.

End to end: robot_s_per_s = B x ticks x control_dt over the window's wall
time, the window ending in a synchronize. Check: the reference's boot
against the program's, and from the program's state at the start of
`check_segments` segments drawn from the seed, the reference's next
`check_ticks` ticks against the program's."""

from __future__ import annotations

import time

import torch

from portbench import tree
from portbench.drivers import closed_loop


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    state = closed_loop.build(config, traffic, seed, device)
    closed_loop.segment(state, traffic["warmup_ticks"])
    _sync(device)
    return state


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(state: dict, seconds: float, tracer) -> dict:
    """The segments, with `check_segments` of them kept for the check: a
    uniform sample of the window's segments drawn from the seed as they
    come (a reservoir, decided before each segment), their start states
    and first traces copied to the host, so that what is kept neither
    grows with the window nor adds to the device's memory."""
    steps = state["traffic"]["segment_ticks"]
    k = state["traffic"]["check_ticks"]
    slots = state["traffic"]["check_segments"]
    g = torch.Generator().manual_seed(int(state["seed"]) % (2 ** 63))
    kept, dead_ticks, segments = {}, None, 0
    t0 = time.perf_counter()
    while True:
        slot = segments if segments < slots else int(
            torch.randint(segments + 1, (), generator=g))
        if slot < slots:
            before = tree.clone(state["carry"], "cpu")
        with tracer.unit():
            res = closed_loop.segment(state, steps)
        if slot < slots:
            kept[slot] = (before, closed_loop.traces(res, k, "cpu"))
        lost = (1.0 - res.alive).sum() * steps
        dead_ticks = lost if dead_ticks is None else dead_ticks + lost
        segments += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(state["device"])
    elapsed = time.perf_counter() - t0
    state["kept"] = [kept[i] for i in sorted(kept)]
    b = state["traffic"]["batch"]
    return {"elapsed_s": elapsed, "units": segments,
            "ticks": segments * steps, "attempted": b * segments * steps,
            "failed": int(round(float(dead_ticks)))}


def end_to_end(state: dict, win: dict) -> dict:
    dt = state["config"]["control_dt"]
    b = state["traffic"]["batch"]
    return {"robot_s_per_s": b * win["ticks"] * dt / win["elapsed_s"]}


def work(state: dict, win: dict) -> dict:
    return {"ticks_per_unit": state["traffic"]["segment_ticks"]}


def lines(state: dict, win: dict) -> list:
    return [f"sweep: {win['units']} segments of "
            f"{state['traffic']['segment_ticks']} ticks at B="
            f"{state['traffic']['batch']} in {win['elapsed_s']:.4f} s, "
            f"{1e3 * win['elapsed_s'] / win['ticks']:.4f} ms a tick"]


def check(state: dict, modes=("program",)) -> dict:
    closed_loop.release(state)
    device = state["device"]
    kept = state.pop("kept")
    return closed_loop.gaps(
        state, [tree.clone(out, device) for _, out in kept],
        [tree.clone(before, device) for before, _ in kept],
        state["traffic"]["check_ticks"], modes)
