"""Matrix-product rate of the Newton-Schulz access pattern on one card.

    python -m quadruped_tpu_torch.benchmarks.mxu_rate [--batch 1024] [--iters 10]

Port of benchmarks/exp_mxu_rate.py (its Pallas kernel and its XLA chain).
Each of `batch` problems holds one 128 x 128 matrix M; `iters` chained
products y = M x with float32 accumulation, each normalised by max|y| of the
problem and cast back to the data type, starting from x = M. Three versions:

  * `unrolled_dots`: the CUDA kernel csrc/unrolled_dots.cu, one thread
    block per problem, M and x in shared memory for the whole chain (port of
    `pallas_unrolled_dots`, the TPU kernel);
  * `unrolled_dots_reference`: the same arithmetic in torch ops, the plain
    version (bf16 data upcast to float32, so the products are exact and only
    the summation order differs from the kernel);
  * `matmul_chain`: `torch.matmul` in the data type itself, the twin of the
    JAX `xla_batched_matmul` (bf16 runs on the card's tensor cores).

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
    benchmark draws them, cast to dtype."""
    m = np.random.default_rng(0).normal(size=(batch, N, N))
    return torch.as_tensor(m, dtype=torch.float32, device=device).to(dtype)


def _normalise(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (y / torch.amax(torch.abs(y), dim=(-2, -1), keepdim=True)).to(dtype)


def unrolled_dots_reference(m: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's chain in torch ops: float32 products of the data-type
    values (callers on the card keep TF32 off)."""
    mf = m.float()
    x = m
    for _ in range(iters):
        x = _normalise(torch.matmul(mf, x.float()), m.dtype)
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
    return lib


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

VERSIONS = {"kernel": unrolled_dots, "plain": unrolled_dots_reference,
            "matmul": matmul_chain}


def measure(batch: int = 1024, iters: int = 10, reps: int = 10,
            device=None) -> dict:
    """{dtype: {version: (ms, TFLOP/s)}} on the card for the three versions.
    FLOPs: 2 * 128^3 per product, batch * iters products."""
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
    res = measure(a.batch, a.iters, a.reps, torch.device("cuda"))
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
