"""Batched dense QP solver, ADMM with OSQP-style splitting (port of quadruped_tpu/solvers/qp.py).

Problem form:   min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u
Equalities are rows with l == u. Operands carry any leading batch axes.

One inverse per solve, M = P + sigma I + A^T diag(rho) A (the block-Schur
`inv_spd` with two Newton steps), then a fixed number of ADMM iterations,
each a mat-vec and a clip. Per-row rho (higher on equality rows),
over-relaxation alpha = 1.6, optional Ruiz equilibration.

`admm_solve` is the function the callers use. On CPU tensors it runs
`admm_solve_reference`, the JAX `lax.scan` as a Python loop of plain torch
ops. On CUDA tensors it launches the dense-QP kernel (csrc/dense_qp.cu,
built with nvcc at the first launch; one warp a problem, the whole solve in
one launch, n up to 20 and m up to 32) or raises; it never falls back to the plain
version there. `admm_solve.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from quadruped_tpu_torch.core import linalg
from quadruped_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_qp.cu"
# Largest n and m the kernel takes: one warp a problem, a lane a row; the
# callers' n are 18 (the WBC), 12 (the polish) and 6 (the pose planner).
MAX_N = 20
MAX_M = 32

DEFAULT_SIGMA = 1e-6
DEFAULT_ALPHA = 1.6
EQ_RHO_SCALE = 1e3
RUIZ_ITERS = 10
BIG_BOUND = 1e7


class QPSolution(NamedTuple):
    x: torch.Tensor          # [..., n] primal solution
    z: torch.Tensor          # [..., m] constraint values (projected)
    y: torch.Tensor          # [..., m] dual solution
    prim_res: torch.Tensor   # [...] final primal residual (inf-norm)
    dual_res: torch.Tensor   # [...] final dual residual (inf-norm)


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: [..., r, c] @ [..., c] -> [..., r]."""
    return torch.einsum("...rc,...c->...r", m, v)


def default_rho(l: torch.Tensor, u: torch.Tensor,
                rho: float = 0.1) -> torch.Tensor:
    """Per-row rho: `rho` for inequalities, EQ_RHO_SCALE*rho for equalities."""
    is_eq = (u - l) < 1e-9
    return torch.where(is_eq, rho * EQ_RHO_SCALE, rho).to(l.dtype)


def ruiz_equilibrate(p, q, a, l, u, iters: int = RUIZ_ITERS):
    """Symmetric Ruiz equilibration of the KKT data (OSQP 'scaling').

    Returns (p', q', a', l', u', d, e, c): x = d * x', y = e * y' / c.
    Infinite bounds are preserved."""
    n = p.shape[-1]
    m = a.shape[-2]
    d = torch.ones(p.shape[:-2] + (n,), dtype=p.dtype, device=p.device)
    e = torch.ones(a.shape[:-2] + (m,), dtype=p.dtype, device=p.device)
    c = torch.ones(p.shape[:-2], dtype=p.dtype, device=p.device)
    ps, qs, as_ = p, q, a

    def safe_inv_sqrt(x):
        # Zero rows/columns (masked-out constraints) keep scale 1.
        return torch.where(x > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(x, 1e-12, 1e12)),
                           torch.ones_like(x))

    for _ in range(iters):
        col_p = torch.amax(torch.abs(ps), dim=-2)
        col_a = torch.amax(torch.abs(as_), dim=-2)
        dd = safe_inv_sqrt(torch.maximum(col_p, col_a))
        row_a = torch.amax(torch.abs(as_), dim=-1)
        ee = safe_inv_sqrt(row_a)
        ps = dd[..., :, None] * ps * dd[..., None, :]
        qs = qs * dd
        as_ = ee[..., :, None] * as_ * dd[..., None, :]
        d = d * dd
        e = e * ee
        # Cost normalization: mean column norm of P' and norm of q'.
        gamma = 1.0 / torch.clamp(
            torch.maximum(torch.mean(torch.amax(torch.abs(ps), dim=-2),
                                     dim=-1),
                          torch.amax(torch.abs(qs), dim=-1)), 1e-8, 1e8)
        ps = ps * gamma[..., None, None]
        qs = qs * gamma[..., None]
        c = c * gamma

    ls = torch.where(l <= -BIG_BOUND, l, e * l)
    us = torch.where(u >= BIG_BOUND, u, e * u)
    return ps, qs, as_, ls, us, d, e, c


def admm_solve_reference(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                         l: torch.Tensor, u: torch.Tensor, *,
                         rho: torch.Tensor | float | None = None,
                         sigma: float = DEFAULT_SIGMA,
                         alpha: float = DEFAULT_ALPHA, iters: int = 60,
                         x0: torch.Tensor | None = None,
                         y0: torch.Tensor | None = None,
                         scale: bool = True) -> QPSolution:
    """`admm_solve` in plain torch ops, on any device (the kernel's
    arithmetic, in the same order)."""
    if scale:
        p0_, q0_, a0_, l0_, u0_ = p, q, a, l, u
        p, q, a, l, u, d_s, e_s, c_s = ruiz_equilibrate(p, q, a, l, u)
        if x0 is not None:
            x0 = x0 / d_s
        if y0 is not None:
            y0 = y0 * c_s[..., None] / e_s

    n = p.shape[-1]
    if rho is None:
        rho_vec = default_rho(l, u)
    else:
        rho_vec = torch.broadcast_to(
            torch.as_tensor(rho, dtype=p.dtype, device=p.device), l.shape)
    rho_inv = 1.0 / rho_vec

    at = a.transpose(-1, -2)
    m_mat = (p + sigma * torch.eye(n, dtype=p.dtype, device=p.device)
             + at @ (rho_vec[..., :, None] * a))
    # Two Newton steps: M carries 1000x-rho equality rows, and its inverse
    # error shifts the ADMM fixed point 1:1.
    m_inv = linalg.inv_spd(m_mat, refine=2)

    x = torch.zeros_like(q) if x0 is None else x0
    z = torch.clamp(mv(a, x), l, u)
    y = torch.zeros_like(l) if y0 is None else y0

    for _ in range(iters):
        rhs = sigma * x - q + mv(at, rho_vec * z - y)
        x_t = mv(m_inv, rhs)
        z_t = mv(a, x_t)
        x_new = alpha * x_t + (1 - alpha) * x
        z_relaxed = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_relaxed + rho_inv * y, l, u)
        y = y + rho_vec * (z_relaxed - z_new)
        x, z = x_new, z_new

    if scale:
        # Unscale: x = D x', y = E y' / c.
        x = x * d_s
        y = y * e_s / c_s[..., None]
        p, q, a, l, u = p0_, q0_, a0_, l0_, u0_
        z = torch.clamp(mv(a, x), l, u)
        at = a.transpose(-1, -2)

    ax = mv(a, x)
    prim = torch.amax(torch.abs(ax - torch.clamp(ax, l, u)), dim=-1)
    dual_vec = mv(p.transpose(-1, -2), x) + q + mv(at, y)
    dual = torch.amax(torch.abs(dual_vec), dim=-1)
    return QPSolution(x=x, z=z, y=y, prim_res=prim, dual_res=dual)


def smem_bytes() -> int:
    """Dynamic shared memory of one block of the kernel: four warps, each
    with three MAX_N x MAX_N matrices, A as MAX_M x MAX_N and four 32-float
    vectors."""
    return 4 * 4 * (3 * MAX_N * MAX_N + MAX_M * MAX_N + 4 * 32)


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = cuda_build.build_shared_library(SOURCE, "dense_qp")
    lib = ctypes.CDLL(str(path))
    lib.dense_qp_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.dense_qp_launch.restype = ctypes.c_int
    return lib


def _batched(name: str, t: torch.Tensor, batch: torch.Size,
             tail: tuple) -> torch.Tensor:
    """t broadcast to batch + tail with its leading axes flattened into one;
    a stride-0 batch (one matrix for every problem) stays a view, and the
    trailing axes are made contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"admm_solve: {name} has dtype {t.dtype}, the "
                        f"kernel takes float32")
    try:
        t = t.expand(batch + tail)
    except RuntimeError as err:
        raise ValueError(f"admm_solve: {name} of shape {tuple(t.shape)} does "
                         f"not broadcast to {tuple(batch + tail)}") from err
    t = t.reshape((-1,) + tail)
    want = 1
    for size, stride in zip(reversed(tail), reversed(t.stride()[1:])):
        if size > 1 and stride != want:
            return t.contiguous()
        want *= size
    return t


def _kernel_operands(p, q, a, l, u, rho, x0, y0):
    """Checks the operands the kernel takes and flattens their batch:
    returns (batch shape, [p, q, a, l, u, rho, x0, y0] as `_batched` gives
    them, None where absent; a float rho as a full row). Raises ValueError
    on a shape or device and TypeError on a dtype the kernel does not
    take."""
    n, m = q.shape[-1], l.shape[-1]
    if not (1 <= n <= MAX_N and 1 <= m <= MAX_M):
        raise ValueError(f"admm_solve: n = {n}, m = {m}; the kernel takes "
                         f"1 <= n <= {MAX_N}, 1 <= m <= {MAX_M}")
    if (p.dim() < 2 or a.dim() < 2 or p.shape[-2:] != (n, n)
            or a.shape[-2:] != (m, n) or u.shape[-1] != m):
        raise ValueError(f"admm_solve: shapes p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}, a {tuple(a.shape)}, l "
                         f"{tuple(l.shape)}, u {tuple(u.shape)}")
    if rho is not None and not isinstance(rho, torch.Tensor):
        rho = torch.tensor(float(rho), device=q.device)
    tensors = {"p": p, "q": q, "a": a, "l": l, "u": u, "rho": rho,
               "x0": x0, "y0": y0}
    for name, t in tensors.items():
        if t is not None and t.device != q.device:
            raise ValueError(f"admm_solve: {name} on {t.device}, q on "
                             f"{q.device}")
    try:
        batch = torch.broadcast_shapes(
            p.shape[:-2], q.shape[:-1], a.shape[:-2], l.shape[:-1],
            u.shape[:-1], *(t.shape[:-1] for t in (x0, y0) if t is not None))
    except RuntimeError as err:
        raise ValueError(f"admm_solve: batch axes do not broadcast: "
                         f"{err}") from err
    tails = {"p": (n, n), "a": (m, n), "q": (n,), "x0": (n,)}
    ops = [None if t is None else _batched(name, t, batch,
                                           tails.get(name, (m,)))
           for name, t in tensors.items()]
    return batch, ops


def admm_solve(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
               l: torch.Tensor, u: torch.Tensor, *,
               rho: torch.Tensor | float | None = None,
               sigma: float = DEFAULT_SIGMA, alpha: float = DEFAULT_ALPHA,
               iters: int = 60, x0: torch.Tensor | None = None,
               y0: torch.Tensor | None = None,
               scale: bool = True) -> QPSolution:
    """Solve a batch of dense QPs with a fixed ADMM iteration budget.

    Warm start through (x0, y0). With scale=True the data is
    Ruiz-equilibrated first; residuals are reported in the original
    (unscaled) problem. p [..., n, n], q [..., n], a [..., m, n], l and
    u [..., m], rho None (default_rho), a float or a tensor that broadcasts
    to l; leading axes broadcast against each other. CPU tensors take
    `admm_solve_reference`; CUDA tensors the kernel, in float32 with
    n <= MAX_N and m <= MAX_M, else this raises."""
    if q.device.type == "cpu":
        return admm_solve_reference(p, q, a, l, u, rho=rho, sigma=sigma,
                                    alpha=alpha, iters=iters, x0=x0, y0=y0,
                                    scale=scale)
    batch, ops = _kernel_operands(p, q, a, l, u, rho, x0, y0)
    if q.device.type != "cuda":
        raise ValueError(f"admm_solve: no kernel for device {q.device}")
    n, m = q.shape[-1], l.shape[-1]
    b = batch.numel()
    out = {k: torch.empty((b,) + tail, dtype=torch.float32, device=q.device)
           for k, tail in (("x", (n,)), ("z", (m,)), ("y", (m,)),
                           ("prim", ()), ("dual", ()))}
    if b:
        strides = (ctypes.c_longlong * 8)(
            *(0 if t is None else t.stride(0) for t in ops))
        err = _library().dense_qp_launch(
            *(None if t is None else t.data_ptr() for t in ops), strides,
            *(t.data_ptr() for t in out.values()), b, n, m, iters,
            int(bool(scale)), sigma, alpha,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"admm_solve kernel launch failed: CUDA error "
                               f"{err}")
        admm_solve.launches += 1
    return QPSolution(
        x=out["x"].view(batch + (n,)), z=out["z"].view(batch + (m,)),
        y=out["y"].view(batch + (m,)), prim_res=out["prim"].view(batch),
        dual_res=out["dual"].view(batch))


admm_solve.launches = 0


def kkt_residuals(p, q, a, l, u, sol: QPSolution):
    """Diagnostic KKT residuals (stationarity, feasibility, complementarity)."""
    ax = mv(a, sol.x)
    stationarity = mv(p, sol.x) + q + mv(a.transpose(-1, -2), sol.y)
    prim = torch.clamp(ax - u, min=0.0) + torch.clamp(l - ax, min=0.0)
    comp = torch.minimum(torch.abs(ax - l), torch.abs(u - ax)) \
        * torch.abs(sol.y)
    return (torch.amax(torch.abs(stationarity), -1), torch.amax(prim, -1),
            torch.amax(comp, -1))
