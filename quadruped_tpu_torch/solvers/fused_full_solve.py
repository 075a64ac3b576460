"""Fully fused cone-QP solve (Newton-Schulz inverse + ADMM loop): CUDA kernel
wrapper and plain version.

Port of quadruped_tpu/solvers/pallas_admm.py::fused_full_solve. The kernel
(csrc/fused_full_solve.cu) takes M itself, not its inverse: one thread
block per problem inverts M by the mixed-precision Newton-Schulz iteration
on the tensor cores and runs every ADMM iteration on the result; see the
source for the arithmetic and what bounds it.

`fused_full_solve` is the wrapper `cone_qp.solve_fused_full` calls. On CPU
tensors it runs `fused_full_solve_reference`, the same arithmetic in torch
ops. On CUDA tensors it launches the kernel (built with nvcc at the first
launch) or raises; it never falls back to the plain version there.
`fused_full_solve.launches` counts kernel launches.

Layout as in solvers/fused_admm.py: live sizes n = 3T, m = 5T, mu per
problem. The kernel pads M to 128 x 128, so n <= 128 on every device, as
the Pallas kernel's N_PAD = 128 (H = 10, or H = 16 with move blocking
(4, 2): n = 120; H = 16 unblocked, n = 192, is refused).
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from quadruped_tpu_torch.solvers import fused_admm as _fa
from quadruped_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_full_solve.cu"


N_PAD = 128
# Dynamic shared memory of one block, whatever n: three bf16 128 x 128
# tiles (M, X, 2I - MX), 1024 bytes to align them, 32 floats of reduction
# scratch and the loop's vectors (csrc/fused_full_solve.cu kSmemBytes).
SMEM_BYTES = 3 * N_PAD * N_PAD * 2 + 1024 + (32 + _fa.VECTOR_FLOATS) * 4


def _steps(ns_iters: int, ns_f32_polish: int) -> tuple[int, int]:
    """(bf16 steps, float32 polish steps), as the Pallas kernel splits them."""
    return max(ns_iters - ns_f32_polish, 0), min(ns_f32_polish, ns_iters)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) bf16(b) summed in float32, as a float32 tensor: the kernel's
    bf16-in, f32-accumulate product. On the card it is one bf16 product on
    the tensor cores with a float32 result, the working type of the kernel;
    on the CPU the products of bf16 values are exact in float32 and summed
    there."""
    if a.is_cuda:
        return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(_bf16(a), _bf16(b))


def dot_3pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b as pallas_admm._dot_f32_3pass computes it: both operands split
    into bf16 hi + lo parts, hi.hi + hi.lo + lo.hi, three `bf16_product`s
    summed in float32."""
    a_hi, b_hi = _bf16(a), _bf16(b)
    a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
    return (bf16_product(a_hi, b_hi) + bf16_product(a_hi, b_lo)
            + bf16_product(a_lo, b_hi))


def newton_schulz_reference(m: torch.Tensor, ns_iters: int,
                            ns_f32_polish: int,
                            live: int | None = None) -> torch.Tensor:
    """The kernel's inverse in torch ops: X0 = I (1 / ||M||_inf), bf16 steps
    X <- X_b (2I - M_b X_b)_b (subscript b: rounded to bf16; products in
    `bf16_product`, the result kept in float32), then polish steps
    X <- X (2I - M X) with both products in `dot_3pass`.

    This is the Pallas kernel's schedule; it differs from
    `cone_qp.newton_schulz_inverse` (the closed loop's inverse) in three
    roundings: X0's reciprocal is taken in float32, not bf16, the last bf16
    step's product is not rounded before the polish, and the polish is the
    3-pass split, not a float32 product.

    `live` (default: all rows) sets X0's diagonal on the first `live` rows
    only, as the kernel does on M padded with zeros beyond its live block.
    """
    n = m.shape[-1]
    n_bf, n_f32 = _steps(ns_iters, ns_f32_polish)
    norm = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    x0_diag = eye if live is None else torch.diag(
        (torch.arange(n, device=m.device) < live).to(m.dtype))
    x = x0_diag * (1.0 / norm)[:, None, None]
    for _ in range(n_bf):
        x = bf16_product(x, 2.0 * eye - bf16_product(m, x))
    for _ in range(n_f32):
        x = dot_3pass(x, 2.0 * eye - dot_3pass(m, x))
    return x


def fused_full_solve_reference(m, q, mu, lo, hi, rho, x0, y0, *,
                               ns_iters: int, ns_f32_polish: int, iters: int,
                               sigma: float, alpha: float,
                               accel_restart: int = 0):
    """The kernel in plain torch ops; returns (x [B, n], y [B, m], X).

    Its loop contracts over X's first index (x_t = X^T rhs), as the Pallas
    full solve's does, so K1's plain loop (x_t = M^{-1} rhs) is given X^T.
    """
    m_inv = newton_schulz_reference(m, ns_iters, ns_f32_polish)
    x, y = _fa.fused_admm_reference(m_inv.transpose(1, 2), q, mu, lo, hi,
                                    rho, x0, y0,
                                    iters=iters, sigma=sigma, alpha=alpha,
                                    accel_restart=accel_restart)
    return x, y, m_inv


@functools.lru_cache(maxsize=None)
def _library():
    import ctypes

    path, _ = cuda_build.build_shared_library(SOURCE, "fused_full_solve")
    lib = ctypes.CDLL(str(path))
    lib.fused_full_solve_launch.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.fused_full_solve_launch.restype = ctypes.c_int
    return lib


def fused_full_solve(m, q, mu, lo, hi, rho, x0, y0, *, ns_iters: int,
                     ns_f32_polish: int, iters: int, sigma: float,
                     alpha: float, accel_restart: int = 0,
                     return_inverse: bool = False):
    """Invert each M by Newton-Schulz, then run `iters` ADMM iterations.

    m [B, n, n] (M, not its inverse), q [B, n], mu [B], lo/hi/rho [B, m],
    x0 [B, n], y0 [B, m], float32 on one device. Returns (x [B, n],
    y [B, m]), and the inverse [B, n, n] third when `return_inverse`.
    Raises ValueError for n > 128 on every device, and on the card for n
    not a multiple of 12 (n = 12 G).
    """
    _fa.check_operands(m, q, mu, lo, hi, rho, x0, y0, mat_name="m")
    b, n = q.shape
    if n > N_PAD:
        raise ValueError(f"n = {n}: the kernel pads M to {N_PAD} x {N_PAD}, "
                         f"so n <= {N_PAD}")
    kw = dict(iters=iters, sigma=sigma, alpha=alpha,
              accel_restart=accel_restart)
    if q.device.type == "cpu":
        x, y, m_inv = fused_full_solve_reference(
            m, q, mu, lo, hi, rho, x0, y0, ns_iters=ns_iters,
            ns_f32_polish=ns_f32_polish, **kw)
        return (x, y, m_inv) if return_inverse else (x, y)
    if q.device.type != "cuda":
        raise ValueError(f"fused_full_solve: no kernel for device {q.device}")
    if n % 12:
        raise ValueError(f"n = {n}: the kernel takes n = 12 G")
    lib = _library()
    args = [t.contiguous() for t in (m, q, mu, lo, hi, rho, x0, y0)]
    x = torch.empty_like(args[6])
    y = torch.empty_like(args[7])
    m_inv = torch.empty_like(args[0]) if return_inverse else None
    n_bf, n_f32 = _steps(ns_iters, ns_f32_polish)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fused_full_solve_launch(
        *[t.data_ptr() for t in args], x.data_ptr(), y.data_ptr(),
        None if m_inv is None else m_inv.data_ptr(), b, n, n_bf, n_f32,
        iters, sigma, alpha, accel_restart, stream)
    if err != 0:
        raise RuntimeError(f"fused_full_solve kernel launch failed: CUDA "
                           f"error {err}")
    fused_full_solve.launches += 1
    return (x, y, m_inv) if return_inverse else (x, y)


fused_full_solve.launches = 0
