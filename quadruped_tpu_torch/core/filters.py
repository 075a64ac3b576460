"""Signal filters (port of quadruped_tpu/core/filters.py): the moving-window
mean with its state in a batch-first dataclass, and the first-order
command filter."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MovingWindowState:
    """Ring buffer of a moving-window mean, per scenario.

    buf:   [B, window, ...] samples (zeros until written)
    idx:   [B] int32 next write position
    count: [B] int32 number of valid samples (saturates at window)
    """

    buf: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor


def moving_window_init(batch: int, window: int, sample_shape,
                       device) -> MovingWindowState:
    return MovingWindowState(
        buf=torch.zeros((batch, window) + tuple(sample_shape),
                        dtype=torch.float32, device=device),
        idx=torch.zeros(batch, dtype=torch.int32, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device))


def moving_window_update(state: MovingWindowState, x: torch.Tensor):
    """Push a sample x [B, ...]; returns (new state, windowed mean [B, ...]).

    The mean is the dense sum over the window divided by the valid count,
    as in the JAX module (no running sum). The sum adds the window's slots
    in order, the order of XLA's reduction over a non-minor axis, so that
    the mean is the same float32 number (the contact latch downstream
    compares it against thresholds)."""
    window = state.buf.shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    buf = state.buf.clone()
    buf[rows, state.idx.long()] = x
    idx = ((state.idx + 1) % window).to(torch.int32)
    count = torch.clamp(state.count + 1, max=window).to(torch.int32)
    total = buf[:, 0]
    for k in range(1, window):
        total = total + buf[:, k]
    denom = torch.clamp(count, min=1).to(buf.dtype)
    mean = total / denom.reshape(denom.shape + (1,) * (total.ndim - 1))
    return MovingWindowState(buf, idx, count), mean


def low_pass(prev: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """First-order low-pass: alpha*prev + (1-alpha)*x."""
    return alpha * prev + (1.0 - alpha) * x
