"""The comparison that decides `correct`: gaps between what the timed path
produced and what the plain reference works out from the same inputs, each
against its limit in `limits/<cell>.json`."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch

LIMITS = Path(__file__).with_name("limits")
G = 9.81


def gap(program: torch.Tensor, reference: torch.Tensor,
        scale: float = 1.0) -> float:
    """The widest |program - reference| over every entry, over `scale`.
    An entry non-finite on one side only is an infinite gap; non-finite on
    both sides (a scenario frozen after it fell) is none."""
    p = program.detach().to(torch.float64).cpu()
    r = reference.detach().to(torch.float64).cpu()
    if p.shape != r.shape:
        raise ValueError(f"shapes differ: {tuple(p.shape)} vs "
                         f"{tuple(r.shape)}")
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    if bool((fp != fr).any()):
        return float("inf")
    d = torch.where(fp, (p - r).abs(), torch.zeros_like(p))
    return float(d.max()) / scale if d.numel() else 0.0


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 matrix products on the TF32 tensor
    cores (a no-op on the CPU)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def limits(cell: str) -> dict:
    """{number: limit} of a cell ({} where it has no file)."""
    path = LIMITS / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def verdict(numbers: dict, cell_limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    has a limit, every limit a number, and each number is within its
    limit."""
    checks = {k: {"value": v, "limit": cell_limits.get(k)}
              for k, v in numbers.items()}
    for k in cell_limits:
        checks.setdefault(k, {"value": None, "limit": cell_limits[k]})
    ok = bool(checks) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
