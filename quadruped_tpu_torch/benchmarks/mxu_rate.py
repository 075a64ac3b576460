"""Matrix-product rate of the Newton-Schulz access pattern on one card.

    python -m quadruped_tpu_torch.benchmarks.mxu_rate [--batch 1024] [--iters 10]

Port of benchmarks/exp_mxu_rate.py (its Pallas kernel and its XLA chain).
Each of `batch` problems holds one 128 x 128 matrix M; `iters` chained
products y = M x with float32 accumulation, each normalised by max|y| of the
problem and cast back to the data type, starting from x = M. Three versions:

  * `unrolled_dots`: the CUDA kernel csrc/unrolled_dots.cu (port of
    `pallas_unrolled_dots`, the TPU kernel), one thread block per problem,
    M and x in shared memory for the whole chain, the products on the
    tensor cores: bf16 through csrc/tc_product.cuh (the product of
    fused_full_solve's Newton-Schulz stage), float32 as three TF32 passes
    through csrc/tf32_product.cuh (`tf32_chain` repeats that arithmetic);
  * `unrolled_dots_reference`: the same chain in torch ops, the plain
    version: exact float32 products of the data-type values summed in
    float32 (TF32 off), so the bf16 kernel differs from it only in the
    tensor cores' summation order and rounding, and the float32 kernel by
    the three-pass split as well;
  * `matmul_chain`: `torch.matmul` in the data type itself, the twin of the
    JAX `xla_batched_matmul` (bf16 runs on the card's tensor cores).

`accuracy` gives the kernel's distance from the plain version and the
readings that set its limits: both against the chain summed in float64,
and a control (bf16 cast by truncation, float32 one TF32 pass) against the
plain version.

`main` prints ms and TFLOP/s of the three for bf16 and float32 data, with
the card's name and power limit. There is no CPU path: without a CUDA
device `main` fails.
"""

from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import numpy as np
import torch

from quadruped_tpu_torch.utils import card, cuda_build

N = 128
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "unrolled_dots.cu"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def problems(batch: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """[batch, 128, 128] standard normal matrices from seed 0, as the JAX
    benchmark draws them, cast to dtype, on the card unless `device` says
    otherwise."""
    device = card.resolve(device)
    m = np.random.default_rng(0).normal(size=(batch, N, N))
    return torch.as_tensor(m, dtype=torch.float32, device=device).to(dtype)


def _normalise(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (y / torch.amax(torch.abs(y), dim=(-2, -1), keepdim=True)).to(dtype)


def unrolled_dots_reference(m: torch.Tensor, iters: int,
                            sums: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's chain in torch ops: products of the data-type values in
    `sums`, exact and summed in float32 for the plain version (callers on
    the card keep TF32 off); `sums=torch.float64` gives the witness that
    `accuracy` holds both the kernel and the plain version against."""
    ms = m.to(sums)
    x = m
    for _ in range(iters):
        x = _normalise(torch.matmul(ms, x.to(sums)), m.dtype)
    return x


def truncated_chain(m: torch.Tensor, iters: int) -> torch.Tensor:
    """The bf16 plain chain with y / max|y| cast to bf16 toward zero instead
    of to nearest-even: the control for the bf16 limit, the chain of a
    kernel whose store truncated."""
    mf = m.float()
    x = m
    for _ in range(iters):
        y = _normalise(torch.matmul(mf, x.float()), torch.float32)
        x = (y.view(torch.int32) & -0x10000).view(torch.float32).to(m.dtype)
    return x


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as the card's cvt.rna.tf32.f32; the low 13 bits of the result
    are zero. For finite v."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_chain(m: torch.Tensor, iters: int, passes: int = 3) -> torch.Tensor:
    """The float32 chain with each product taken as the kernel takes it:
    M and x split into hi = tf32_round(v) and lo = tf32_round(v - hi), and
    y = M_hi x_hi + M_hi x_lo + M_lo x_hi (CUTLASS's 3xTF32), each pass a
    float32 product whose terms, products of TF32 values, are exact
    (callers on the card keep TF32 off). passes=1 keeps M_hi x_hi alone, a
    plain TF32 product."""
    if passes not in (1, 3):
        raise ValueError(f"passes: {passes}, expected 1 or 3")

    def split(v):
        hi = tf32_round(v)
        return hi, tf32_round(v - hi)

    m_hi, m_lo = split(m.float())
    x = m.float()
    for _ in range(iters):
        x_hi, x_lo = split(x)
        y = torch.matmul(m_hi, x_hi)
        if passes == 3:
            y = y + torch.matmul(m_hi, x_lo) + torch.matmul(m_lo, x_hi)
        x = _normalise(y, torch.float32)
    return x


def matmul_chain(m: torch.Tensor, iters: int) -> torch.Tensor:
    """The same chain with `torch.matmul` in the data type (the twin of the
    JAX `xla_batched_matmul`); bf16 products round to bf16 before the
    normalisation."""
    x = m
    for _ in range(iters):
        x = _normalise(torch.matmul(m, x).float(), m.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _library():
    import ctypes

    path, _ = cuda_build.build_shared_library(SOURCE, "unrolled_dots")
    lib = ctypes.CDLL(str(path))
    lib.unrolled_dots_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.unrolled_dots_launch.restype = ctypes.c_int
    lib.unrolled_dots_smem_bytes.argtypes = [ctypes.c_int]
    lib.unrolled_dots_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(tag: str) -> int:
    """Dynamic shared memory of one kernel block for data type `tag`, as the
    built library gives it (builds the library)."""
    return int(_library().unrolled_dots_smem_bytes(int(tag == "bf16")))


def unrolled_dots(m: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain for m [B, 128, 128] (bf16 or float32). On CPU tensors the
    plain version runs; on CUDA tensors the kernel launches or this raises.
    `unrolled_dots.launches` counts kernel launches."""
    if m.dim() != 3 or tuple(m.shape[1:]) != (N, N):
        raise ValueError(f"m: shape {tuple(m.shape)}, expected [B, {N}, {N}]")
    if m.dtype not in DTYPES.values():
        raise TypeError(f"m: dtype {m.dtype}, expected bfloat16 or float32")
    if m.device.type == "cpu":
        return unrolled_dots_reference(m, iters)
    if m.device.type != "cuda":
        raise ValueError(f"unrolled_dots: no kernel for device {m.device}")
    lib = _library()
    m = m.contiguous()
    if m.data_ptr() % 16:
        raise ValueError("unrolled_dots: the kernel reads m in 16-byte "
                         "chunks; m must start on a 16-byte boundary")
    out = torch.empty_like(m)
    err = lib.unrolled_dots_launch(
        m.data_ptr(), out.data_ptr(), m.shape[0], iters,
        int(m.dtype == torch.bfloat16),
        torch.cuda.current_stream(m.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unrolled_dots kernel launch failed: CUDA error "
                           f"{err}")
    unrolled_dots.launches += 1
    return out


unrolled_dots.launches = 0


def _diff(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    d = (a.double() - b.double()).abs()
    return d.max().item(), d.mean().item()


def accuracy(batch: int = 1024, iters: int = 10, device=None) -> dict:
    """{dtype: {reading: (max |diff|, mean |diff|)}} for the chain of
    `problems`: the kernel against the plain version; both against the
    witness summed in float64; the control against the plain version (bf16
    `truncated_chain`, float32 one TF32 pass); for float32 also the kernel
    against its own arithmetic, `tf32_chain`. The problems lie on the card
    unless `device` says otherwise; callers on the card keep TF32 off."""
    device = card.resolve(device)
    out = {}
    for tag, dtype in DTYPES.items():
        m = problems(batch, dtype, device)
        got = unrolled_dots(m, iters)
        plain = unrolled_dots_reference(m, iters)
        witness = unrolled_dots_reference(m, iters, torch.float64)
        control = (truncated_chain(m, iters) if tag == "bf16"
                   else tf32_chain(m, iters, passes=1))
        out[tag] = {"kernel_vs_plain": _diff(got, plain),
                    "kernel_vs_f64": _diff(got, witness),
                    "plain_vs_f64": _diff(plain, witness),
                    "control_vs_plain": _diff(control, plain)}
        if tag == "f32":
            out[tag]["kernel_vs_3pass"] = _diff(got, tf32_chain(m, iters))
    return out


VERSIONS = {"kernel": unrolled_dots, "plain": unrolled_dots_reference,
            "matmul": matmul_chain}


def measure(batch: int = 1024, iters: int = 10, reps: int = 10,
            device=None) -> dict:
    """{dtype: {version: (ms, TFLOP/s)}} on the card for the three versions.
    FLOPs: 2 * 128^3 per product, batch * iters products. The problems lie
    on the card unless `device` says otherwise."""
    device = card.resolve(device)
    flops = 2 * N ** 3 * batch * iters
    out = {}
    for tag, dtype in DTYPES.items():
        m = problems(batch, dtype, device)
        out[tag] = {}
        for name, fn in VERSIONS.items():
            ms = card.time_ms(lambda: fn(m, iters), reps)
            out[tag][name] = (ms, flops / (ms * 1e-3) / 1e12)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_rate: no CUDA device; the benchmark measures "
                         "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = measure(a.batch, a.iters, a.reps)
    print(f"card: {card.name_and_power_limit()}")
    for tag, versions in res.items():
        for name, (ms, tflops) in versions.items():
            print(f"  {tag:4s} {name:6s}: {ms:8.3f} ms  {tflops:7.2f} TFLOP/s"
                  f"  (batch={a.batch}, iters={a.iters})")
    print(json.dumps({tag: {name: {"ms": ms, "tflops": tf}
                            for name, (ms, tf) in versions.items()}
                      for tag, versions in res.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
