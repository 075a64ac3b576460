"""The card the port runs on: the default device of its entry points, the
card a measurement ran on (for the lines that carry a time or a rate), and
device time on it."""

from __future__ import annotations

import subprocess

import torch


def default_device() -> torch.device:
    """The device an entry point builds on when its caller names none: the
    card. Raises when there is no card; it never falls back to the CPU
    (CPU callers pass device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's entry points run on "
                           "the card unless the caller passes device='cpu'")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as given, else `default_device()`."""
    return default_device() if device is None else torch.device(device)


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
