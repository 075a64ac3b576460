"""What the example modules share: the device argument, traces written into
preallocated device tensors, the timed tick loop and the report line."""

from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile
import time

import numpy as np
import torch

from quadruped_tpu_torch.utils import card


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap


def out_path(name: str) -> str:
    """The default path of an output file: `name` in the temporary
    directory (the JAX scripts write to /tmp)."""
    return os.path.join(tempfile.gettempdir(), name)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Per-tick traces in tensors of [T, ...] allocated on the first write
    of each key, on the device of the value: no copy to the host and no
    sync inside the loop; `numpy()` copies each to the host once."""

    def __init__(self, ticks: int):
        self.ticks = ticks
        self.traces: dict[str, torch.Tensor] = {}

    def put(self, k: int, **values: torch.Tensor):
        for key, value in values.items():
            buf = self.traces.get(key)
            if buf is None:
                buf = self.traces[key] = value.new_empty(
                    (self.ticks,) + tuple(value.shape))
            buf[k] = value

    def numpy(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self.traces.items()}


class LoopClock:
    """Wall seconds of a tick loop, the device synchronized at both ends."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.seconds = time.perf_counter() - self.t0


def timed(out: dict, ticks: int, clock: LoopClock) -> dict:
    """`out` with the tick count and the loop's seconds."""
    out["ticks"] = ticks
    out["loop_s"] = clock.seconds
    return out


def report(device: torch.device, out: dict):
    """The line every example prints: the card's name and power limit (or
    the CPU), ms a tick and the tick count."""
    where = (card.name_and_power_limit() if device.type == "cuda"
             else str(device))
    ticks = out["ticks"]
    ms = 1e3 * out["loop_s"] / max(ticks, 1)
    print(f"device: {where}; {ms:.3f} ms a tick over {ticks} ticks",
          flush=True)


def have_matplotlib() -> bool:
    """Whether the renders can run; without matplotlib `main` says so and
    writes no image (the traces are still returned by `run`)."""
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no image written", flush=True)
        return False
    return True


def pose_recorder(ticks: int):
    """(Recorder, on_tick) for the whole-body loops of `benchmarks/`: the
    first scenario's base position, roll-pitch-yaw, joint angles and
    contact flags after each tick, the parts of a `utils.viz3d.Viz3DTrace`."""
    from quadruped_tpu_torch.core import se3

    rec = Recorder(ticks)

    def on_tick(k, sim, flags):
        rec.put(k, position=sim.fb.position[0],
                rpy=se3.quat_to_rpy(sim.fb.quat)[0], q=sim.fb.q[0],
                contact=flags[0])

    return rec, on_tick


def render3d(params, out: dict, path: str, every: int, fps: int,
             terrain=None) -> str:
    """The JAX scripts' 3-D renders of a pose trace (drawn on the host:
    `params` and `terrain` on the CPU): an animated GIF at `path` and a
    three-panel PNG beside it (first, middle and last tick). Returns the
    line the scripts print."""
    from quadruped_tpu_torch.utils import viz3d

    trace = viz3d.Viz3DTrace(position=out["position"], rpy=out["rpy"],
                             joint_angles=out["q"], contact=out["contact"])
    steps = len(out["position"])
    gif = viz3d.animate_rollout(params, trace, path, every=every, fps=fps,
                                terrain=terrain)
    png = viz3d.snapshot(params, trace, path.rsplit(".", 1)[0] + ".png",
                         ticks=(0, steps // 2, steps - 1), terrain=terrain)
    return f"wrote {gif} and {png}"


def terrain_loop(terrain_height, hook, qp_iters: int, device):
    """The stair-climb and gap-crossing examples' loop: one A1 walking at
    0.03 m/s (body height 0.27 m) on the whole-body sim over
    `terrain_height`, the walk loop of `benchmarks/walk.py` with the 3.7 s
    walk table, the stance gains of the JAX scripts, `qp_iters` force-QP
    iterations and the foothold hook `hook`, booted."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk

    return bench_walk.build(
        1, device, bench_walk.walk_config(bench_walk.walk_table(device),
                                          qp_iters),
        vx=[0.03], terrain_height=terrain_height, foothold_adjust_fn=hook)


def terrain_walk(loop, steps: int, device) -> dict:
    """`steps` ticks of a `terrain_loop`: the pose traces of
    `pose_recorder`, the legs' sub-states [T, 4], the loop's time and
    `loop`, the terrain loop advanced by the run."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk

    rec, on_tick = pose_recorder(steps)
    with LoopClock(device) as clock:
        loop, tr = bench_walk.run(loop, steps, record=True, on_tick=on_tick)
    out = rec.numpy()
    out["sub_state"] = tr["sub_state"][0].cpu().numpy()
    out["loop"] = loop
    return timed(out, steps, clock)
