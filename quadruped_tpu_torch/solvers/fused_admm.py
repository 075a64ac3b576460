"""Fused ADMM loop of the MPC cone QP: CUDA kernel wrapper and plain version.

Port of quadruped_tpu/solvers/pallas_admm.py::fused_admm. The kernel
(csrc/fused_admm.cu) runs every ADMM iteration of one problem in one
thread block with that problem's M^{-1} in the registers of its threads;
see the source for what it computes and what bounds it.

`fused_admm` is the wrapper the solver calls. On CPU tensors it runs
`fused_admm_reference`, the same loop in torch ops. On CUDA tensors it
launches the kernel (built with nvcc at the first launch) or raises; it
never falls back to the plain version there. `fused_admm.launches` counts
kernel launches, so a run can show that its solves went through the kernel.

Layout (live sizes, no TPU lane padding): n = 3T variables, m = 5T
constraint rows, rows 5t..5t+4 are the friction pyramid of force triple t
(fx + mu fz, -fx + mu fz, fy + mu fz, -fy + mu fz, fz).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from quadruped_tpu_torch.utils import cuda_build
from quadruped_tpu_torch.utils.logging import span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_admm.cu"
# Largest n the kernel takes: 768 threads a block hold M^{-1} in registers
# (csrc/admm_loop.cuh), enough for H = 16 unblocked.
MAX_N = 192
# Padded length of rhs and x_t in shared memory (admm_loop.cuh kVecPad).
VEC_PAD = 256


def _apply_a(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """[B, 3T] -> [B, 5T]: rows of the per-triple pyramid, mu per problem."""
    b, n = x.shape
    fx, fy, fz = x.view(b, n // 3, 3).unbind(-1)
    mfz = mu[:, None] * fz
    return torch.stack([fx + mfz, -fx + mfz, fy + mfz, -fy + mfz, fz],
                       dim=-1).reshape(b, -1)


def _apply_at(w: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """[B, 5T] -> [B, 3T]: A^T w."""
    b, m = w.shape
    w0, w1, w2, w3, w4 = w.view(b, m // 5, 5).unbind(-1)
    return torch.stack([w0 - w1, w2 - w3,
                        mu[:, None] * (w0 + w1 + w2 + w3) + w4],
                       dim=-1).reshape(b, -1)


def fused_admm_reference(m_inv, q, mu, lo, hi, rho, x0, y0, *, iters: int,
                         sigma: float, alpha: float, accel_restart: int = 0,
                         z0=None):
    """The kernel's loop in plain torch ops; returns (x [B, n], y [B, m]).

    Same arithmetic as the kernel and as pallas_admm._admm_loop, with the
    mat-vec x_t = M^{-1} rhs of the JAX `solve` (the Pallas kernel
    contracts over its matrix's first index, so it computes this loop when
    it is given M^{-1} transposed); 1/rho is taken once, and
    the momentum schedule (t_k, beta) is float32 per iteration. With
    accel_restart == 0, beta is 0 and (z_hat, y_hat) = (z, y): the relaxed
    scheme. The loop starts from z0 [B, m] where it is given (an iterate
    carried from a loop that ran the first iterations), else from
    clip(A x0, lo, hi).
    """
    rho_inv = 1.0 / rho
    x, y = x0, y0
    z = torch.clamp(_apply_a(x, mu), lo, hi) if z0 is None else z0
    z_hat, y_hat = z, y
    tk = np.float32(1.0)
    for k in range(iters):
        rhs = sigma * x - q + _apply_at(rho * z_hat - y_hat, mu)
        x_t = torch.bmm(rhs[:, None, :], m_inv.transpose(1, 2))[:, 0]
        z_t = _apply_a(x_t, mu)
        x = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z_hat
        z_new = torch.clamp(z_rel + y_hat * rho_inv, lo, hi)
        y_new = y_hat + rho * (z_rel - z_new)
        beta = np.float32(0.0)
        if accel_restart > 0:
            if k % accel_restart == accel_restart - 1:
                tk_next = np.float32(1.0)
            else:
                tk_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
                    np.float32(1.0) + np.float32(4.0) * tk * tk))
                beta = (tk - np.float32(1.0)) / tk_next
            tk = tk_next
        if beta:
            z_hat = z_new + float(beta) * (z_new - z)
            y_hat = y_new + float(beta) * (y_new - y)
        else:
            z_hat, y_hat = z_new, y_new
        z, y = z_new, y_new
    return x, y


@functools.lru_cache(maxsize=None)
def _library():
    import ctypes

    path, _ = cuda_build.build_shared_library(SOURCE, "fused_admm")
    lib = ctypes.CDLL(str(path))
    lib.fused_admm_launch.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_admm_launch.restype = ctypes.c_int
    return lib


# Floats of the vectors in shared memory: rhs and x_t, each padded to
# VEC_PAD (admm_loop.cuh kVectorFloats; every other vector lives in
# registers).
VECTOR_FLOATS = 2 * VEC_PAD


def check_operands(mat, q, mu, lo, hi, rho, x0, y0, mat_name="m_inv",
                   z0=None):
    """Raise on operands the ADMM kernels do not take: shapes [B, n, n],
    [B, n], [B], [B, m] x3, [B, n], [B, m] and, where given, z0 [B, m]
    (n = 3T, m = 5T), all float32 on one device."""
    b, n = q.shape
    m = (n // 3) * 5
    if n % 3:
        raise ValueError(f"n = {n} is not a whole number of force triples")
    shapes = {mat_name: (b, n, n), "q": (b, n), "mu": (b,), "lo": (b, m),
              "hi": (b, m), "rho": (b, m), "x0": (b, n), "y0": (b, m),
              "z0": (b, m)}
    args = {mat_name: mat, "q": q, "mu": mu, "lo": lo, "hi": hi, "rho": rho,
            "x0": x0, "y0": y0}
    if z0 is not None:
        args["z0"] = z0
    for name, t in args.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def fused_admm(m_inv, q, mu, lo, hi, rho, x0, y0, *, iters: int,
               sigma: float, alpha: float, accel_restart: int = 0, z0=None):
    """Run `iters` ADMM iterations per problem; returns (x [B, n], y [B, m]).

    m_inv [B, n, n], q [B, n], mu [B], lo/hi/rho [B, m], x0 [B, n],
    y0 [B, m] and optionally z0 [B, m] (the loop's z to start from; None:
    clip(A x0, lo, hi)), all float32 on one device (n = 3T, m = 5T). Each
    iteration's mat-vec is M^{-1} rhs, as in the JAX `solve`.
    """
    with span("qtpu.qp.admm"):
        check_operands(m_inv, q, mu, lo, hi, rho, x0, y0, z0=z0)
        kw = dict(iters=iters, sigma=sigma, alpha=alpha,
                  accel_restart=accel_restart, z0=z0)
        if q.device.type == "cpu":
            return fused_admm_reference(m_inv, q, mu, lo, hi, rho, x0, y0,
                                        **kw)
        if q.device.type != "cuda":
            raise ValueError(f"fused_admm: no kernel for device {q.device}")
        b, n = q.shape
        if n % 12 or n > MAX_N:
            raise ValueError(f"n = {n}: the kernel takes n = 12 G <= {MAX_N}")
        lib = _library()
        args = [t.contiguous() for t in (m_inv, q, mu, lo, hi, rho, x0, y0)]
        x = torch.empty_like(args[6])
        y = torch.empty_like(args[7])
        stream = torch.cuda.current_stream(q.device).cuda_stream
        z0c = None if z0 is None else z0.contiguous()
        err = lib.fused_admm_launch(
            *[t.data_ptr() for t in args],
            None if z0c is None else z0c.data_ptr(), x.data_ptr(),
            y.data_ptr(), b, n, iters, sigma, alpha, accel_restart, stream)
        if err != 0:
            raise RuntimeError(f"fused_admm kernel launch failed: CUDA error "
                               f"{err}")
        fused_admm.launches += 1
        return x, y


fused_admm.launches = 0
