"""The chained-product benchmark of the port
(quadruped_tpu_torch/benchmarks/mxu_rate.py).

* On CPU: the plain version `unrolled_dots_reference` and the matmul twin
  against the same chain written in jnp (`pallas_unrolled_dots` has no
  interpret mode and returns only a time), bf16 and float32.
* On the card (marker `cuda`): the CUDA kernel against the plain version.
  This module imports no JAX at module level, so the card test also runs
  where JAX is absent:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \\
          tests/test_torch_mxu_rate.py
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.benchmarks import mxu_rate

B = 4
ITERS = 3
DTYPES = list(mxu_rate.DTYPES)


def _jnp_chain(m, iters):
    """exp_mxu_rate.py's chain: float32-accumulated products of the
    data-type values, max-normalised, cast back each step."""
    import jax
    import jax.numpy as jnp

    x = m
    for _ in range(iters):
        y = jnp.einsum("bij,bjk->bik", m, x,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        y = y / jnp.max(jnp.abs(y), axis=(-2, -1), keepdims=True)
        x = y.astype(m.dtype)
    return np.asarray(x.astype(jnp.float32))


# (function, dtype) -> (max |diff|, mean |diff|) against the jnp chain.
# Entries are <= 1 after each normalisation. float32: summation order only.
# bf16, plain version: the same exact products summed in another order, so
# a value near a rounding tie may round one bf16 step (2^-8) the other way
# and carry into the next product (measured max 2e-3, mean 2e-7). bf16,
# matmul twin: torch.matmul in bf16 also rounds y to bf16 before the
# normalisation, one more rounding per product (measured max 7.8e-3, mean
# 8.3e-4).
TOL = {("plain", "f32"): (1e-5, 1e-6), ("plain", "bf16"): (1e-2, 1e-5),
       ("matmul", "f32"): (1e-5, 1e-6), ("matmul", "bf16"): (2e-2, 2e-3)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_chain_matches_jnp(dtype):
    """The plain version and the matmul twin against the jnp chain, within
    TOL."""
    import jax.numpy as jnp

    m = mxu_rate.problems(B, mxu_rate.DTYPES[dtype])
    want = _jnp_chain(jnp.asarray(m.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32), ITERS)
    for name in ("plain", "matmul"):
        got = mxu_rate.VERSIONS[name](m, ITERS)
        assert got.dtype == m.dtype and got.shape == m.shape
        diff = np.abs(got.float().numpy() - want)
        max_tol, mean_tol = TOL[(name, dtype)]
        assert diff.max() <= max_tol and diff.mean() <= mean_tol, name


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version (bit-identical)
    and counts no launch; it refuses other shapes and types."""
    m = mxu_rate.problems(2, torch.bfloat16)
    before = mxu_rate.unrolled_dots.launches
    assert torch.equal(mxu_rate.unrolled_dots(m, 2),
                       mxu_rate.unrolled_dots_reference(m, 2))
    assert mxu_rate.unrolled_dots.launches == before
    with pytest.raises(ValueError):
        mxu_rate.unrolled_dots(torch.zeros(2, 64, 64), 2)
    with pytest.raises(TypeError):
        mxu_rate.unrolled_dots(torch.zeros(2, 128, 128, dtype=torch.half), 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Kernel vs plain version on the card: the same exact float32 products
# summed in another order, as the plain version against jnp above.
KERNEL_TOL = {"bf16": TOL[("plain", "bf16")][0],
              "f32": TOL[("plain", "f32")][0]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """CUDA kernel vs its plain version, B=64, 10 products, within
    KERNEL_TOL (1e-5 for float32, so a chain rounded to bf16 fails)."""
    m = mxu_rate.problems(64, mxu_rate.DTYPES[dtype], cuda_device)
    before = mxu_rate.unrolled_dots.launches
    got = mxu_rate.unrolled_dots(m, 10)
    want = mxu_rate.unrolled_dots_reference(m, 10)
    torch.cuda.synchronize()
    assert mxu_rate.unrolled_dots.launches == before + 1
    err = float((got.float() - want.float()).abs().max())
    assert err <= KERNEL_TOL[dtype]
