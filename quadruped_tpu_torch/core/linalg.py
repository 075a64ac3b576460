"""Small-matrix batched SPD inverse (port of quadruped_tpu/core/linalg.py).

`inv_spd` is the JAX module's recursive block-Schur inverse on top of the
closed-form 3x3 adjugate, with Jacobi pre-scaling, the residual guard and
Newton refinement, ported as written: the parity tests compare against this
arithmetic, so `torch.linalg.inv` does not stand in for it.
"""

from __future__ import annotations

import torch

from quadruped_tpu_torch.core.se3 import inv3x3, matmul3 as matmul_small


def _split(n: int) -> int:
    """Leading-block size for the Schur recursion (multiples of 3 when
    possible so the base case is the closed-form 3x3)."""
    if n % 3 == 0:
        return 3 * max(1, (n // 3) // 2)
    return n // 2


def inv_spd(m: torch.Tensor, refine: int = 1) -> torch.Tensor:
    """[..., n, n] SPD inverse by recursive block-Schur elimination."""
    n = m.shape[-1]
    if n <= 3:
        return _inv_spd_schur(m)
    d = torch.sqrt(torch.abs(torch.diagonal(m, dim1=-2, dim2=-1)) + 1e-30)
    s = 1.0 / d
    ms = s[..., :, None] * m * s[..., None, :]
    inv = _inv_spd_schur(ms)
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    eye2 = 2.0 * eye
    # Residual guard: Newton contracts iff ||I - M X0|| < 1; fall back to
    # X0 = I/||M||_inf where the Schur seed is outside that radius (NaN
    # compares false and falls back too).
    resid = torch.amax(torch.sum(torch.abs(eye - matmul_small(ms, inv)),
                                 dim=-1), dim=-1)
    norminf = torch.amax(torch.sum(torch.abs(ms), dim=-1), dim=-1)
    safe = eye / norminf[..., None, None]
    inv = torch.where((resid < 0.9)[..., None, None], inv, safe)
    for _ in range(refine):
        inv = matmul_small(inv, eye2 - matmul_small(ms, inv))
    return s[..., :, None] * inv * s[..., None, :]


def _inv_spd_schur(m: torch.Tensor) -> torch.Tensor:
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        rows = [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)]
        return torch.stack(rows, dim=-2) / det[..., None, None]
    if n == 3:
        return inv3x3(m)
    n1 = _split(n)
    a = m[..., :n1, :n1]
    b = m[..., :n1, n1:]
    d = m[..., n1:, n1:]
    a_inv = _inv_spd_schur(a)
    w = matmul_small(a_inv, b)
    s = d - matmul_small(b.transpose(-1, -2), w)
    s_inv = _inv_spd_schur(s)
    ws = matmul_small(w, s_inv)
    tl = a_inv + matmul_small(ws, w.transpose(-1, -2))
    tr = -ws
    top = torch.cat([tl, tr], dim=-1)
    bottom = torch.cat([tr.transpose(-1, -2), s_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)
