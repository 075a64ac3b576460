"""Readings for a cell's correctness limits, many seeds in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--seconds 3] [--control 1]

For each seed: the cell's set-up, a window of `--seconds` at the cell's
own size and load, then the numbers its check compares, for the program
("program") and, with --control 1, for the control ("control": the
reference in the nearest precision below the configuration's, float32
products on the TF32 tensor cores, in the program's place). One JSON line
per seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness
from portbench.trace import Tracer


def readings(name: str, seed: int, seconds: float, control: bool,
             device, overrides: dict | None = None) -> dict:
    files = harness.cell_files(name)
    driver = files["driver"]
    traffic = dict(files["traffic"], **(overrides or {}))
    t0 = time.perf_counter()
    state = driver.setup(files["config"], traffic, seed, device)
    setup_s = time.perf_counter() - t0
    win = driver.window(state, seconds, Tracer(False, 0, device))
    modes = ("program", "control") if control else ("program",)
    t1 = time.perf_counter()
    numbers = driver.check(state, modes)
    return {"workload": name, "seed": seed, "setup_s": setup_s,
            "units": win["units"], "failed": win["failed"],
            "check_s": time.perf_counter() - t1, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(readings(a.workload, seed, a.seconds,
                                  bool(a.control), device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
