"""The least time the card could take for a piece of work: the larger of
its bytes over the memory rate and its operations over the peak rate of
their type (peaks.json). The work is counted from the problem's shapes, so
it stays the same whatever implements it."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """(seconds, "bytes" or "operations")."""
    t_bytes = bytes_moved / PEAKS["bytes_per_s"]
    t_ops = sum(n / PEAKS["ops_per_s"][kind] for kind, n in ops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def admm_work(batch: int, n: int, iters: int) -> tuple[float, dict]:
    """(bytes, ops) of the cone QP's ADMM loop on B problems of n = 3T
    variables and m = 5T constraint rows, float32: M^{-1} (n x n), q, mu,
    lo, hi, rho, x0, y0 read once, x and y written once; per iteration the
    mat-vec (2 n^2), A x and A^T w (4 m) and the z, y and x updates
    (12 m + 4 n)."""
    m = 5 * n // 3
    floats = n * n + 3 * n + 1 + 5 * m
    ops = iters * (2 * n * n + 16 * m + 4 * n)
    return 4.0 * batch * floats, {"f32": float(batch * ops)}
