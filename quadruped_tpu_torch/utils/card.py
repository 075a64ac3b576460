"""The card a measurement ran on, for the lines that carry a time or a rate,
and device time on it."""

from __future__ import annotations

import subprocess

import torch


def name_and_power_limit() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them; the
    power limit bounds the clocks under load, so every time is kept beside
    it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over reps calls (CUDA events), after
    one untimed call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
