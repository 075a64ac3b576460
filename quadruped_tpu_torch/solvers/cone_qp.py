"""Batched friction-cone QP solver for the MPC (port of quadruped_tpu/solvers/cone_qp.py).

Same scheme as the JAX `solve`: per-triple scalar equilibration with cost
normalization, per-row rho with a 100x boost on pinned fz rows,
M = gamma d P d + sigma I + blockdiag(A^T rho A), a mixed-precision
Newton-Schulz inverse of M (on the card one kernel, csrc/newton_schulz.cu,
where the JAX package leaves it to XLA; torch ops on the CPU and for
n > 128), then the ADMM loop. The loop is the
`fused_admm` kernel (solvers/fused_admm.py), whose mat-vec is the JAX
`solve`'s M^{-1} rhs (the Pallas loop of `solve_fused` contracts over the
first index, M^{-T} rhs, which differs by the inverse's asymmetry); the
port has one function, the closed loop's solver, and no `solve_fused`.
`solve_fused_full` hands M
itself to the `fused_full_solve` kernel, which inverts it and runs the loop
on chip.

Two options of the JAX `solve` are here too, both off by default. The
cross-cadence inverse carry (`InverseCarry`, `seeded_inverse`): the
previous cadence solve's M^{-1}, rescaled through both equilibrations,
corrected for the pin flips by a block Woodbury update and polished by a
short Newton-Schulz run, in place of the cold 11-step inverse. The bf16
head (`bf16_iters`): the first iterations of the relaxed loop with M^{-1}
rounded to bf16, in torch ops as JAX runs them in XLA, and the float32
rest in the kernel, which continues from the head's (x, z, y).

Batch-first: `ConeQP.p` is [B, n, n] with n = 3T, `mu` is [B].
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.solvers.fused_admm import (_apply_a, _apply_at,
                                                    fused_admm)
from quadruped_tpu_torch.solvers.fused_full_solve import fused_full_solve
from quadruped_tpu_torch.utils import cuda_build
from quadruped_tpu_torch.utils.logging import span

SIGMA = 1e-6
ALPHA = 1.6
RHO_CONE = 0.05
NS_ITERS = 11
BIG = 1e8
# Post-polish probe residual above which `seeded_inverse(rescue_iters > 0)`
# replaces a scenario's inverse by the cold one: several times what a
# single-polish inverse leaves (max|I - MX| ~1e-3), far below a diverged
# polish.
RESCUE_RESID = 1e-2
NS_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "newton_schulz.cu"
# Largest n the inverse's kernel takes (its 128 tile). A larger M, only the
# unblocked H = 16 MPC's (n = 192), keeps the torch ops on every device.
NS_MAX_N = 128
# cuBLAS (12.8, TF32 off, on the H100) multiplies a batch of matrices in
# chunks of at most 65535, and a lone matrix, a batch or last chunk of one,
# by split-K: each entry chains over k-slices of LONE_SPLIT[n] k's, each
# from zero, summed in order (cutlass's SIMT sgemm and splitKreduce; read
# on the card, every n = 12 G but 12, whose order is not found). The
# inverse's kernel follows it for such a matrix.
CUBLAS_BATCH_CHUNK = 65535
LONE_SPLIT = {24: 8, 36: 12, 48: 12, 60: 4, 72: 8, 84: 8, 96: 32, 108: 8,
              120: 8}


@dataclasses.dataclass
class ConeQP:
    """min 1/2 x^T P x + q^T x  s.t. per-triple cones on x.reshape(T, 3):
    4 pyramid rows >= 0 and fz in [fz_lo[t], fz_hi[t]]."""

    p: torch.Tensor       # [B, n, n], n = 3T
    q: torch.Tensor       # [B, n]
    mu: torch.Tensor      # [B] friction coefficient
    fz_lo: torch.Tensor   # [B, T]
    fz_hi: torch.Tensor   # [B, T]


@dataclasses.dataclass
class ConeSolution:
    x: torch.Tensor         # [B, n]
    y: torch.Tensor         # [B, T, 5] duals
    prim_res: torch.Tensor  # [B]


class AdmmInputs(NamedTuple):
    """The scaled problem as the ADMM kernel takes it, plus the scales."""

    m_inv: torch.Tensor   # [B, n, n] (None from `admm_operands`)
    q: torch.Tensor       # [B, n]
    mu: torch.Tensor      # [B]
    lo: torch.Tensor      # [B, 5T]
    hi: torch.Tensor      # [B, 5T]
    rho: torch.Tensor     # [B, 5T]
    x0: torch.Tensor      # [B, n]
    y0: torch.Tensor      # [B, 5T]
    d: torch.Tensor       # [B, n] variable scaling
    gamma: torch.Tensor   # [B] cost normalization
    d_t: torch.Tensor     # [B, T] per-triple scaling (d = d_t repeated)
    pinned: torch.Tensor  # [B, T] 1.0 where fz_hi ~ fz_lo (the 100x rows)


class InverseCarry(NamedTuple):
    """What `solve` carries from one cadence solve to the next for
    `seeded_inverse` (JAX cone_qp.InverseCarry): the inverse of the scaled
    M, the scales it was built with and its pin pattern.

    M changes between 15 ms cadence solves by a small drift of the
    equilibrated cost and by a jump of +/- 99 rho on the fz diagonal of
    every triple whose pin flips with the trot table: one coordinate
    rank-1 term a flipped triple, which the Woodbury step removes exactly.
    `rho` is the rho the carried inverse was built with ([B] from `solve`,
    or a float): the Woodbury step sizes the jumps it removes with it and
    the jumps it adds with the new solve's rho. A change of the base rho
    on the unpinned rows is not removed; the polish absorbs it as a small
    drift, so a carry is meant for solves at the same rho up to a few
    percent (the JAX package's rule, mirrored)."""

    m_inv: torch.Tensor   # [B, n, n]
    d_t: torch.Tensor     # [B, T]
    gamma: torch.Tensor   # [B]
    pinned: torch.Tensor  # [B, T] float
    rho: torch.Tensor | float = RHO_CONE


def cone_pattern(mu: torch.Tensor) -> torch.Tensor:
    """[..., 5, 3] rows: [fx+mu fz, -fx+mu fz, fy+mu fz, -fy+mu fz, fz]."""
    zero = torch.zeros_like(mu)
    one = torch.ones_like(mu)
    rows = [
        torch.stack([one, zero, mu], dim=-1),
        torch.stack([-one, zero, mu], dim=-1),
        torch.stack([zero, one, mu], dim=-1),
        torch.stack([zero, -one, mu], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and back: a float32 product of two such operands
    with TF32 off is the float32 sum of exact bf16 products, what the JAX
    code's bf16 dots with preferred_element_type=float32 compute."""
    return x.to(torch.bfloat16).to(x.dtype)


def _newton_schulz_steps(m: torch.Tensor, x: torch.Tensor, n_bf: int,
                         n_f32: int) -> torch.Tensor:
    """Newton-Schulz steps X <- X (2I - M X) from the seed x: `n_bf` with X
    carried in bf16 and float32 products of the bf16 operands, then `n_f32`
    in float32. With n_bf = 0 the seed is used as it is."""
    n = m.shape[-1]
    eye2 = 2.0 * torch.eye(n, dtype=m.dtype, device=m.device)
    if n_bf > 0:
        x_bf = x.to(torch.bfloat16)
        m_bf = _bf16(m)
        for _ in range(n_bf):
            xf = x_bf.to(m.dtype)
            inner = eye2 - torch.matmul(m_bf, xf)
            x_bf = torch.matmul(xf, _bf16(inner)).to(torch.bfloat16)
        x = x_bf
    x = x.to(m.dtype)
    for _ in range(n_f32):
        x = torch.matmul(x, eye2 - torch.matmul(m, x))
    return x


def newton_schulz_inverse_reference(m: torch.Tensor, iters: int = NS_ITERS,
                                    f32_polish: int = 2) -> torch.Tensor:
    """Batched SPD inverse by Newton-Schulz, X <- X (2I - M X), X0 = I/||M||_inf.

    All but the last `f32_polish` steps carry X in bf16 and take float32
    products of the bf16 operands before the subtraction (the JAX code's
    preferred_element_type=float32); the polish steps run in full float32.
    Callers on the card keep TF32 off, so the float32 products are exact
    products of the bf16 values. The plain version of
    `newton_schulz_inverse`'s kernel, in torch ops.
    """
    n = m.shape[-1]
    norminf = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    n_bf = max(iters - f32_polish, 0)
    x_bf = (torch.eye(n, dtype=torch.bfloat16, device=m.device)
            / norminf.to(torch.bfloat16)[..., None, None])
    return _newton_schulz_steps(m, x_bf, n_bf, iters - n_bf)


def ns_layout(n: int) -> tuple[int, int, int]:
    """(tile, ld, shared bytes a block) of the inverse's kernel at n = 12 G
    <= NS_MAX_N (csrc/newton_schulz.cu). The tile: 64 for n <= 64, else
    128. ld, the row stride of its three float32 n x ld buffers (M, X,
    T): the first multiple of 4 from n at which the A reads of up to 8 row
    groups of a warp fall in distinct banks, (r ld) mod 32 distinct for
    r < 8."""
    tile = 64 if n <= 64 else 128
    ld = n
    while len({(r * ld) % 32 for r in range(8)}) < 8:
        ld += 4
    return tile, ld, 3 * n * ld * 4


def check_inverse_input(m: torch.Tensor) -> None:
    """Raise on an M the inverse's kernel does not take: [..., n, n],
    float32, contiguous, n = 12 G <= NS_MAX_N."""
    if m.dim() < 2 or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"m: shape {tuple(m.shape)}, expected [..., n, n]")
    if m.dtype != torch.float32:
        raise TypeError(f"m: dtype {m.dtype}, expected float32")
    if not m.is_contiguous():
        raise ValueError("m is not contiguous")
    n = m.shape[-1]
    if n % 12 or n > NS_MAX_N:
        raise ValueError(f"n = {n}: the kernel takes n = 12 G <= {NS_MAX_N}")


@functools.lru_cache(maxsize=None)
def _ns_library():
    import ctypes

    path, _ = cuda_build.build_shared_library(NS_SOURCE, "newton_schulz")
    lib = ctypes.CDLL(str(path))
    lib.newton_schulz_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.newton_schulz_launch.restype = ctypes.c_int
    return lib


def newton_schulz_inverse(m: torch.Tensor, iters: int = NS_ITERS,
                          f32_polish: int = 2) -> torch.Tensor:
    """Batched SPD inverse by Newton-Schulz, X <- X (2I - M X), X0 = I/||M||_inf,
    `iters` steps of which the last `f32_polish` are float32: the
    arithmetic of `newton_schulz_inverse_reference`.

    The route, by device and shape: CPU tensors, and M larger than the
    kernel's tile (n > NS_MAX_N, on every device), take the torch ops of
    `newton_schulz_inverse_reference`. A CUDA tensor of n <= NS_MAX_N
    launches the kernel (csrc/newton_schulz.cu; built with nvcc at the
    first launch), one launch a call after the torch ops of X0's diagonal,
    or raises (`check_inverse_input`); it never falls back to the torch
    ops. The kernel sums every product in the order cuBLAS does with TF32
    off, a lone matrix's too (`lone_split`), so on the card it returns
    what the torch ops return, bit for bit, for the cuBLAS the card tests
    ran with. `newton_schulz_inverse.launches` counts the calls that
    launch the kernel.
    """
    n = m.shape[-1]
    if m.device.type == "cpu" or n > NS_MAX_N:
        return newton_schulz_inverse_reference(m, iters, f32_polish)
    if m.device.type != "cuda":
        raise ValueError(f"newton_schulz_inverse: no kernel for device "
                         f"{m.device}")
    check_inverse_input(m)
    batch = m.numel() // (n * n)
    if m.data_ptr() % 16:
        m = m.clone()
    x = _ns_launch(m.reshape(batch, n, n), iters, f32_polish,
                   lone_split(batch, n))
    newton_schulz_inverse.launches += 1
    return x.reshape(m.shape)


newton_schulz_inverse.launches = 0


def lone_split(batch: int, n: int) -> int:
    """The k-slice of the last problem's products where cuBLAS multiplies
    it alone (B = 1 mod CUBLAS_BATCH_CHUNK), else 0: one chain."""
    if batch % CUBLAS_BATCH_CHUNK != 1:
        return 0
    return LONE_SPLIT.get(n, 0)


def _ns_launch(flat: torch.Tensor, iters: int, f32_polish: int,
               split: int) -> torch.Tensor:
    """The inverse's kernel on [B, n, n] float32 (16-byte aligned,
    contiguous), the last problem's products in k-slices of `split` where
    it is above 0 (`lone_split`)."""
    n = flat.shape[-1]
    # X0's diagonal as newton_schulz_inverse_reference divides it.
    norminf = torch.amax(torch.sum(torch.abs(flat), dim=-1), dim=-1)
    x0 = (torch.ones(1, 1, dtype=torch.bfloat16, device=flat.device)
          / norminf.to(torch.bfloat16)[:, None, None]).to(flat.dtype)
    x = torch.empty_like(flat)
    n_bf = max(iters - f32_polish, 0)
    err = _ns_library().newton_schulz_launch(
        flat.data_ptr(), x0.data_ptr(), x.data_ptr(), flat.shape[0], n,
        *ns_layout(n), n_bf, iters - n_bf, split,
        torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"newton_schulz kernel launch failed: CUDA error "
                           f"{err}")
    return x


def _capacitance_inverse(s_cap: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """Exact batched inverse of (I + diag(c) S) [B, T, T] by T sequential
    Sherman-Morrison updates (row k of diag(c) S is the rank-1 term
    c_k e_k S[k, :]): JAX's scan, kept in place of a batched LU. A singular
    intermediate surfaces as non-finite, and `seeded_inverse` then takes
    the cold seed. The identity starts as I + 0 S, so a non-finite S
    propagates as it does in JAX."""
    t = s_cap.shape[-1]
    ainv = torch.eye(t, dtype=s_cap.dtype, device=s_cap.device) \
        + 0.0 * s_cap
    for k in range(t):
        col = ainv[..., :, k]                                 # A^{-1} e_k
        vrow = torch.matmul(s_cap[..., k:k + 1, :], ainv)[..., 0, :]
        ck = c[..., k]
        denom = 1.0 + ck * vrow[..., k]
        ainv = ainv - (ck / denom)[..., None, None] \
            * col[..., :, None] * vrow[..., None, :]
    return ainv


@functools.lru_cache(maxsize=None)
def _probes(n: int, dtype: torch.dtype, device: torch.device):
    """[n, 4] residual probes of `seeded_inverse`: the signs of
    default_rng(7).normal(size=(n, 4)), the JAX package's draw."""
    signs = np.sign(np.random.default_rng(7).normal(size=(n, 4)))
    return torch.tensor(signs, dtype=dtype, device=device)


def probe_residual(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B] estimate of ||I - M X|| from the four sign probes: the largest
    ||(M X - I) p|| / sqrt(n). It bounds the spectral residual from below,
    by up to sqrt(n) where the residual lies in few directions."""
    n = m.shape[-1]
    probes = _probes(n, m.dtype, m.device)
    resid = torch.matmul(m, torch.matmul(x, probes)) - probes
    return torch.amax(torch.sqrt(torch.sum(resid * resid, dim=-2))
                      / float(np.sqrt(n)), dim=-1)


def seeded_inverse(m: torch.Tensor, carry: InverseCarry,
                   d_t_new: torch.Tensor, gamma_new: torch.Tensor,
                   pinned_new: torch.Tensor, rho: float,
                   bf16_iters: int = 4, f32_polish: int = 1,
                   fallback_thresh: float = 0.9,
                   rescue_iters: int = 0) -> torch.Tensor:
    """M^{-1} [B, n, n] from the previous cadence solve's inverse (see
    InverseCarry; JAX cone_qp.seeded_inverse, step for step):

    1. rescale X through both equilibrations, D = (d_prev / d_new)
       sqrt(gamma_prev / gamma_new) per triple;
    2. block Woodbury on the fz coordinates 3t + 2 of the pin flips,
       (M + U C U^T)^{-1} = X - X U (I + C U^T X U)^{-1} C U^T X, with the
       [T, T] capacitance inverted by `_capacitance_inverse`;
    3. a residual estimate from four sign probes: a seed whose estimate
       (x2 margin) passes `fallback_thresh` is damped by
       1 / (||M||_inf ||X||_inf), which makes the polish contract for any
       finite seed; a non-finite estimate takes the cold seed
       I / ||M||_inf;
    4. `bf16_iters` bf16 Newton-Schulz steps and `f32_polish` float32
       ones; a non-finite result takes the cold seed.
    The cold-seed selections are part of the algorithm (a garbage carry
    degrades one solve and the next re-polishes), not a way round a
    device.

    The probe test of step 3 can pass a seed whose residual lies in one
    direction (a pin released on a triple of weak cost curvature: the
    Woodbury step magnifies the carried inverse's error there), and the
    polish then diverges to finite values that step 4's test keeps; JAX
    does the same. rescue_iters > 0 (off by default, as in JAX) measures
    the polished inverse with the probes and gives each scenario above
    RESCUE_RESID the cold `rescue_iters`-step Newton-Schulz inverse, on
    those scenarios only (one host read of the count);
    `seeded_inverse.rescued` counts them."""
    n = m.shape[-1]
    dtype, device = m.dtype, m.device

    s_t = (carry.d_t / d_t_new) \
        * torch.sqrt(carry.gamma / gamma_new)[..., None]
    s = torch.repeat_interleave(s_t, 3, dim=-1)
    x = s[..., :, None] * carry.m_inv * s[..., None, :]

    rho_old = torch.as_tensor(carry.rho, dtype=dtype,
                              device=device)[..., None]
    c = 99.0 * (rho * pinned_new - rho_old * carry.pinned)      # [B, T]
    xu = x[..., :, 2::3]                                        # [B, n, T]
    utx = x[..., 2::3, :]                                       # [B, T, n]
    a_inv = _capacitance_inverse(utx[..., :, 2::3], c)
    x = x - torch.matmul(xu, torch.matmul(a_inv * c[..., None, :], utx))

    r_est = probe_residual(m, x)
    norminf_m = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    norminf_x = torch.amax(torch.sum(torch.abs(x), dim=-1), dim=-1)
    damp = torch.where(2.0 * r_est < fallback_thresh, 1.0,
                       1.0 / (norminf_m * norminf_x))
    x_cold = torch.eye(n, dtype=dtype, device=device) \
        / norminf_m[..., None, None]
    x = torch.where(torch.isfinite(r_est)[..., None, None],
                    damp[..., None, None] * x, x_cold)

    x = _newton_schulz_steps(m, x, bf16_iters, f32_polish)
    ok = torch.isfinite(x).all(dim=-1).all(dim=-1)
    x = torch.where(ok[..., None, None], x, x_cold)
    if rescue_iters > 0:
        bad = torch.nonzero(~(probe_residual(m, x) <= RESCUE_RESID))[:, 0]
        if bad.numel() > 0:
            x = x.index_copy(0, bad, newton_schulz_inverse(
                m[bad], rescue_iters, f32_polish))
            seeded_inverse.rescued += bad.numel()
    return x


seeded_inverse.rescued = 0


def _project(z: torch.Tensor, fz_lo: torch.Tensor, fz_hi: torch.Tensor,
             big: float = BIG) -> torch.Tensor:
    """Clip [., T, 5] constraint values: pyramid rows to [0, big], fz row to
    [fz_lo, fz_hi]."""
    lo = torch.cat([torch.zeros_like(z[..., :4]), fz_lo[..., None]], dim=-1)
    hi = torch.cat([torch.full_like(z[..., :4], big), fz_hi[..., None]],
                   dim=-1)
    return torch.clamp(z, lo, hi)


def _equilibrate_scales(prob: ConeQP):
    """Per-triple scaling + cost normalization (scales only)."""
    n = prob.p.shape[-1]
    t = n // 3
    batch = prob.p.shape[:-2]
    abs_p = torch.abs(prob.p)
    col_norm = torch.amax(abs_p, dim=-2)
    trip_norm = torch.amax(col_norm.reshape(batch + (t, 3)), dim=-1)
    d_t = torch.where(trip_norm > 1e-12, 1.0 / torch.sqrt(trip_norm),
                      torch.ones_like(trip_norm))
    d = torch.repeat_interleave(d_t, 3, dim=-1)
    wcol = torch.amax(d[..., :, None] * abs_p, dim=-2) * d
    q_d = prob.q * d
    gamma = 1.0 / torch.clamp(
        torch.maximum(torch.mean(wcol, dim=-1),
                      torch.amax(torch.abs(q_d), dim=-1)), 1e-12, 1e12)
    q_s = q_d * gamma[..., None]
    return q_s, d, d_t, gamma, prob.fz_lo / d_t, prob.fz_hi / d_t


def admm_operands(prob: ConeQP, rho: float, sigma: float,
                  x0: torch.Tensor | None, y0: torch.Tensor | None):
    """Equilibrate, build M = gamma d P d + sigma I + blockdiag(A^T rho A)
    and lay the problem out as the ADMM kernels take it (warm start scaled
    in). Returns (M [B, n, n], AdmmInputs with m_inv None)."""
    with span("qtpu.qp.operands"):
        b, n, _ = prob.p.shape
        t = n // 3
        dtype, device = prob.p.dtype, prob.p.device
        q_s, d, d_t, gamma, fz_lo, fz_hi = _equilibrate_scales(prob)
        mu = prob.mu.expand(b).contiguous()
        pattern = cone_pattern(mu)                                  # [B, 5, 3]

        # Per-row rho: swing-pinned triples (fz_hi ~ fz_lo) get 100x rho on
        # their fz row (OSQP-style near-equality rows).
        pinned = ((fz_hi - fz_lo) < 1e-6)[..., None]                # [B, T, 1]
        row_template = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                                    device=device)
        rho_rows = rho * (1.0 + 99.0 * pinned * row_template)       # [B, T, 5]
        ata = torch.einsum("bir,btr,brj->btij", pattern.transpose(-1, -2),
                           rho_rows, pattern)
        eye_t = torch.eye(t, dtype=dtype, device=device)
        scale = gamma[:, None, None] * d[:, :, None] * d[:, None, :]
        m_mat = scale * prob.p \
            + sigma * torch.eye(n, dtype=dtype, device=device) \
            + torch.einsum("btij,tu->btiuj", ata, eye_t).reshape(b, n, n)

        zeros4 = torch.zeros(b, t, 4, dtype=dtype, device=device)
        lo = torch.cat([zeros4, fz_lo[..., None]],
                       dim=-1).reshape(b, 5 * t)
        hi = torch.cat([zeros4 + BIG, fz_hi[..., None]],
                       dim=-1).reshape(b, 5 * t)
        x_init = torch.zeros_like(q_s) if x0 is None else x0 / d
        y_init = (torch.zeros(b, 5 * t, dtype=dtype, device=device)
                  if y0 is None
                  else (y0 * gamma[:, None, None]).reshape(b, 5 * t))
        return m_mat, AdmmInputs(m_inv=None, q=q_s, mu=mu, lo=lo, hi=hi,
                                 rho=rho_rows.reshape(b, 5 * t).contiguous(),
                                 x0=x_init, y0=y_init, d=d, gamma=gamma,
                                 d_t=d_t, pinned=pinned[..., 0].to(dtype))


def admm_inputs(prob: ConeQP, *, rho: float = RHO_CONE, sigma: float = SIGMA,
                x0: torch.Tensor | None = None,
                y0: torch.Tensor | None = None, ns_iters: int = NS_ITERS,
                ns_f32_polish: int = 1, inv_carry: InverseCarry | None = None,
                seed_bf16_iters: int = 4,
                seed_rescue: bool = False) -> AdmmInputs:
    """Equilibrate, build M and its inverse, and lay the problem out as the
    ADMM kernel takes it (warm start scaled in). The inverse is the cold
    Newton-Schulz one, or with `inv_carry` the seeded one
    (`seeded_inverse`: `seed_bf16_iters` bf16 steps, then `ns_f32_polish`
    float32 ones; with `seed_rescue` its diverged scenarios get the cold
    `ns_iters`-step inverse)."""
    m_mat, inp = admm_operands(prob, rho, sigma, x0, y0)
    with span("qtpu.qp.inverse"):
        if inv_carry is None:
            m_inv = newton_schulz_inverse(m_mat, ns_iters, ns_f32_polish)
        else:
            m_inv = seeded_inverse(
                m_mat, inv_carry, inp.d_t, inp.gamma, inp.pinned, rho,
                bf16_iters=seed_bf16_iters, f32_polish=ns_f32_polish,
                rescue_iters=ns_iters if seed_rescue else 0)
    return inp._replace(m_inv=m_inv)


def bf16_head(inp: AdmmInputs, iters: int, sigma: float, alpha: float):
    """The first `iters` iterations of the relaxed loop with M^{-1} rounded
    to bf16 (the JAX `solve`'s bf16 loop); returns the iterate (x, z, y).

    As in JAX: rhs goes in as a hi / lo pair of bf16 columns, both through
    one product with float32 sums; the mat-vec is M^{-1} rhs, as in the
    `fused_admm` loop that continues from it."""
    with span("qtpu.qp.admm"):
        m_bf = _bf16(inp.m_inv)
        x, y = inp.x0, inp.y0
        z = torch.clamp(_apply_a(x, inp.mu), inp.lo, inp.hi)
        for _ in range(iters):
            rhs = sigma * x - inp.q + _apply_at(inp.rho * z - y, inp.mu)
            rhs_hi = _bf16(rhs)
            pair = torch.stack([rhs_hi, _bf16(rhs - rhs_hi)], dim=-1)
            xt2 = torch.matmul(m_bf, pair)
            x_t = xt2[..., 0] + xt2[..., 1]
            z_rel = alpha * _apply_a(x_t, inp.mu) + (1.0 - alpha) * z
            x = alpha * x_t + (1.0 - alpha) * x
            z_new = torch.clamp(z_rel + y / inp.rho, inp.lo, inp.hi)
            y = y + inp.rho * (z_rel - z_new)
            z = z_new
        return x, z, y


def _unscale(prob: ConeQP, inp: AdmmInputs, x_s: torch.Tensor,
             y_s: torch.Tensor) -> ConeSolution:
    """Scaled iterates -> solution in the problem's units, with the primal
    residual of the unscaled cone constraints."""
    b, n = x_s.shape
    t = n // 3
    x_out = x_s * inp.d
    y_out = y_s.reshape(b, t, 5) / inp.gamma[:, None, None]
    ax = torch.einsum("bri,bti->btr", cone_pattern(inp.mu),
                      x_out.reshape(b, t, 3))
    ax_proj = _project(ax, prob.fz_lo, prob.fz_hi)
    prim = torch.amax(torch.abs(ax - ax_proj), dim=(-2, -1))
    return ConeSolution(x=x_out, y=y_out, prim_res=prim)


def shift_warm_start(x: torch.Tensor, y: torch.Tensor,
                     pin_prev: torch.Tensor, pin_new: torch.Tensor,
                     n_legs: int = 4):
    """Flip-aware warm start: per scenario, the previous solution shifted
    one horizon step forward (tail duplicated) when the contact table
    advanced between cadence solves, else the solution in place.

    The shifted start is taken when at least one full leg set flipped
    (n_flip >= n_legs) and the new pin pattern matches the shifted previous
    one strictly better. Only meaningful for unblocked horizons.
    x: [B, 12H], y: [B, 4H, 5], pin_*: [B, 4H]; returns (x0, y0).
    """
    b = x.shape[0]
    h = pin_prev.shape[-1] // n_legs

    def shift(v, steps_shape):
        s = v.reshape((b, h) + steps_shape)
        return torch.cat([s[:, 1:], s[:, -1:]], dim=1).reshape(v.shape)

    x_shift = shift(x, (3 * n_legs,))
    y_shift = shift(y, (n_legs, y.shape[-1]))
    pin_sh = shift(pin_prev, (n_legs,))
    n_flip = torch.sum(pin_new != pin_prev, dim=-1)
    n_flip_sh = torch.sum(pin_new != pin_sh, dim=-1)
    use = (n_flip >= n_legs) & (n_flip_sh < n_flip)
    return (torch.where(use[:, None], x_shift, x),
            torch.where(use[:, None, None], y_shift, y))


def solve_fused_full(prob: ConeQP, *, iters: int = 40, rho: float = RHO_CONE,
                     sigma: float = SIGMA, alpha: float = ALPHA,
                     x0: torch.Tensor | None = None,
                     y0: torch.Tensor | None = None,
                     ns_iters: int = NS_ITERS, ns_f32_polish: int = 1,
                     accel_restart: int = 0) -> ConeSolution:
    """`solve` with the Newton-Schulz inverse and the ADMM loop in one
    kernel (solvers/fused_full_solve.py): the equilibration, M and the
    per-row rho are `solve`'s, M goes to the kernel uninverted. The
    kernel's inverse follows the Pallas kernel's rounding schedule
    (`fused_full_solve.newton_schulz_reference`). Raises ValueError when n
    is too large for one block's shared memory (n > 132)."""
    m_mat, inp = admm_operands(prob, rho, sigma, x0, y0)
    x_s, y_s = fused_full_solve(
        m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0, inp.y0,
        ns_iters=ns_iters, ns_f32_polish=ns_f32_polish, iters=iters,
        sigma=sigma, alpha=alpha, accel_restart=accel_restart)
    return _unscale(prob, inp, x_s, y_s)


def solve(prob: ConeQP, *, iters: int = 40, rho: float = RHO_CONE,
          sigma: float = SIGMA, alpha: float = ALPHA,
          x0: torch.Tensor | None = None, y0: torch.Tensor | None = None,
          ns_iters: int = NS_ITERS, ns_f32_polish: int = 1,
          bf16_iters: int = 0, accel_restart: int = 0,
          inv_carry: InverseCarry | None = None, seed_bf16_iters: int = 4,
          seed_rescue: bool = False, return_inv_carry: bool = False):
    """Fixed-budget ADMM on the cone QP, batch [B] first.

    The JAX package's `solve` (Newton-Schulz in XLA, the loop in XLA) maps
    to this function: the loop runs in the `fused_admm` kernel, with the
    same mat-vec M^{-1} rhs.

    accel_restart > 0 is Fast-ADMM (Nesterov momentum on (z, y) restarted
    every accel_restart iterations; pass alpha=1.0 with it).

    inv_carry: the previous cadence solve's carry (`return_inv_carry`) for
    the same scenarios; M^{-1} is then `seeded_inverse` with
    `seed_bf16_iters` bf16 steps instead of the cold Newton-Schulz inverse.
    With return_inv_carry the function returns (ConeSolution,
    InverseCarry). seed_rescue (off by default, as in JAX) gives the
    scenarios whose seeded inverse diverged the cold one
    (`seeded_inverse(rescue_iters=ns_iters)`).

    bf16_iters: run the first bf16_iters iterations of the relaxed scheme
    with M^{-1} in bf16 (`bf16_head`, torch ops) and the rest in the kernel
    from the head's (x, z, y). It perturbs the ADMM operator by ~4e-3, which
    the loop amplifies into tens of N on the forces (the JAX docstring's
    measurement); off by default. Raises ValueError with accel_restart > 0,
    as JAX does.
    """
    if accel_restart > 0 and bf16_iters > 0:
        raise ValueError("accel_restart requires the f32 loop")
    inp = admm_inputs(prob, rho=rho, sigma=sigma, x0=x0, y0=y0,
                      ns_iters=ns_iters, ns_f32_polish=ns_f32_polish,
                      inv_carry=inv_carry, seed_bf16_iters=seed_bf16_iters,
                      seed_rescue=seed_rescue)
    n_bf = min(max(bf16_iters, 0), iters)
    x_s, y_s, z_s = inp.x0, inp.y0, None
    if n_bf > 0:
        x_s, z_s, y_s = bf16_head(inp, n_bf, sigma, alpha)
    if n_bf == 0 or iters > n_bf:
        x_s, y_s = fused_admm(inp.m_inv, inp.q, inp.mu, inp.lo, inp.hi,
                              inp.rho, x_s, y_s, iters=iters - n_bf,
                              sigma=sigma, alpha=alpha,
                              accel_restart=accel_restart, z0=z_s)
    sol = _unscale(prob, inp, x_s, y_s)
    if return_inv_carry:
        return sol, InverseCarry(
            m_inv=inp.m_inv, d_t=inp.d_t, gamma=inp.gamma, pinned=inp.pinned,
            rho=torch.full_like(inp.gamma, rho))
    return sol
