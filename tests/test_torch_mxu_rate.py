"""The chained-product benchmark of the port
(quadruped_tpu_torch/benchmarks/mxu_rate.py).

* On CPU: the plain version `unrolled_dots_reference` and the matmul twin
  against the same chain written in jnp (`pallas_unrolled_dots` has no
  interpret mode and returns only a time), bf16 and float32.
* On CPU: `tf32_round` (the card's cvt.rna.tf32.f32) against the same
  rule in float64, the float32 kernel's arithmetic, three TF32 passes
  (`tf32_chain`), against the jnp chain (one TF32 pass fails that limit),
  the float64 witness against it too (a bf16 chain that casts by
  truncation fails the limit), and the kernel's division-free y / max|y|
  against IEEE division.
* On the card (marker `cuda`): the CUDA kernel against the plain version,
  and the float32 kernel against `tf32_chain` at a tighter limit.
  This module imports no JAX at module level, so the card tests also run
  where JAX is absent:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \\
          tests/test_torch_mxu_rate.py
"""

import numpy as np
import pytest
import torch

from card_device import cuda_device  # noqa: F401
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

    m = mxu_rate.problems(B, mxu_rate.DTYPES[dtype], "cpu")
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
    m = mxu_rate.problems(2, torch.bfloat16, "cpu")
    before = mxu_rate.unrolled_dots.launches
    assert torch.equal(mxu_rate.unrolled_dots(m, 2),
                       mxu_rate.unrolled_dots_reference(m, 2))
    assert mxu_rate.unrolled_dots.launches == before
    with pytest.raises(ValueError):
        mxu_rate.unrolled_dots(torch.zeros(2, 64, 64), 2)
    with pytest.raises(TypeError):
        mxu_rate.unrolled_dots(torch.zeros(2, 128, 128, dtype=torch.half), 2)


# Magnitudes (powers of two) of the rounding tests: float32 subnormals
# (2^-140, 2^-130), the lowest normals, and normal values small to large.
MAGNITUDES = [-140, -130, -125, -60, 0, 60, 120]
SEEDS = [0, 1]


def _tf32_inputs(seed, exponent, n=4096):
    """n float32 values of both signs near 2^exponent with random mantissas,
    then the same values moved onto a rounding tie (low 13 bits 0x1000,
    half a TF32 step)."""
    rng = np.random.default_rng(seed)
    v = (rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
         * 2.0 ** exponent).astype(np.float32)
    ties = ((v.view(np.uint32) & np.uint32(0xFFFFE000))
            | np.uint32(0x1000)).view(np.float32)
    return np.concatenate([v, ties])


def _tf32_round_f64(v):
    """The TF32 rounding rule in float64: to the nearest multiple of the
    TF32 step at |v| (2^(e - 10) for 2^e <= |v| < 2^(e + 1), and 2^-136
    below the normal range), ties away from zero."""
    a = np.abs(v.astype(np.float64))
    _, e = np.frexp(a)
    step = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    return np.sign(v) * np.floor(a / step + 0.5) * step


@pytest.mark.parametrize("exponent", MAGNITUDES)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_round_keeps_ten_mantissa_bits(seed, exponent):
    """tf32_round leaves the low 13 of float32's 23 mantissa bits zero, and
    moves every value by at most half a TF32 step."""
    v = _tf32_inputs(seed, exponent)
    got = mxu_rate.tf32_round(torch.from_numpy(v)).numpy()
    assert not np.any(got.view(np.uint32) & np.uint32(0x1FFF))
    step = np.ldexp(1.0, np.maximum(np.frexp(np.abs(v))[1] - 1, -126) - 10)
    assert np.all(np.abs(got.astype(np.float64) - v) <= step / 2)


@pytest.mark.parametrize("exponent", MAGNITUDES)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_round_to_nearest_ties_away(seed, exponent):
    """tf32_round equals the rule computed in float64, ties (the second
    half of the inputs) rounded away from zero."""
    v = _tf32_inputs(seed, exponent)
    got = mxu_rate.tf32_round(torch.from_numpy(v)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, _tf32_round_f64(v))
    ties = v[len(v) // 2:].astype(np.float64)
    assert np.all(np.abs(got[len(v) // 2:]) > np.abs(ties))


@pytest.mark.parametrize("exponent", MAGNITUDES)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_split_gives_back_value(seed, exponent):
    """hi = tf32(v), lo = tf32(v - hi): hi + lo gives back v within
    2^-21 |v| (or 2^-137, half of TF32's step below the normal range, where
    lo falls under it)."""
    v = torch.from_numpy(_tf32_inputs(seed, exponent))
    hi = mxu_rate.tf32_round(v)
    lo = mxu_rate.tf32_round(v - hi)
    v64 = v.double().numpy()
    err = np.abs(v64 - (hi.double().numpy() + lo.double().numpy()))
    assert np.all(err <= np.maximum(2.0 ** -21 * np.abs(v64), 2.0 ** -137))


def _diff_vs_jnp(dtype, chain):
    """|chain(m, ITERS) - the jnp chain| for the CPU problems of `dtype`."""
    import jax.numpy as jnp

    m = mxu_rate.problems(B, mxu_rate.DTYPES[dtype], "cpu")
    want = _jnp_chain(jnp.asarray(m.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32), ITERS)
    got = chain(m, ITERS)
    assert got.dtype == m.dtype and got.shape == m.shape
    return np.abs(got.float().numpy() - want)


def test_three_tf32_passes_match_jnp():
    """The float32 kernel's arithmetic, M_hi x_hi + M_hi x_lo + M_lo x_hi
    (`tf32_chain`), against the jnp float32 chain within the float32 TOL
    (measured max 7.2e-7, mean 8.7e-8)."""
    diff = _diff_vs_jnp("f32", mxu_rate.tf32_chain)
    max_tol, mean_tol = TOL[("plain", "f32")]
    assert diff.max() <= max_tol and diff.mean() <= mean_tol


def test_one_tf32_pass_fails_f32_tol():
    """One TF32 pass (M_hi x_hi) misses the float32 TOL by far (measured
    max 6.5e-4, mean 8.8e-5), so the limit tells the three-pass kernel from
    a plain TF32 one."""
    diff = _diff_vs_jnp("f32", lambda m, n: mxu_rate.tf32_chain(m, n, 1))
    max_tol, mean_tol = TOL[("plain", "f32")]
    assert diff.max() > 10 * max_tol and diff.mean() > 10 * mean_tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_f64_witness_matches_jnp(dtype):
    """The witness that `mxu_rate.accuracy` holds the kernel and the plain
    version against, the chain summed in float64, against the jnp chain
    within TOL (measured bf16 max 2.0e-3, mean 1.8e-7; float32 max 6.0e-7,
    mean 6.2e-8)."""
    diff = _diff_vs_jnp(dtype, lambda m, n: mxu_rate.unrolled_dots_reference(
        m, n, torch.float64))
    max_tol, mean_tol = TOL[("plain", dtype)]
    assert diff.max() <= max_tol and diff.mean() <= mean_tol


def test_truncating_cast_fails_bf16_tol():
    """The bf16 control, the plain chain cast to bf16 toward zero
    (`truncated_chain`), misses the bf16 mean TOL by far (measured max
    7.8e-3, mean 8.4e-4): the mean limit tells a store that truncates from
    one that rounds to nearest-even, where the max limit alone would not."""
    diff = _diff_vs_jnp("bf16", mxu_rate.truncated_chain)
    assert diff.mean() > 10 * TOL[("plain", "bf16")][1]


def test_accuracy_readings_on_cpu():
    """`mxu_rate.accuracy`, the readings the card test holds the kernel with,
    on CPU tensors (the wrapper takes the plain version): kernel and plain
    equal, the float64 witness inside the plain TOL, the controls far
    outside it."""
    acc = mxu_rate.accuracy(B, ITERS, "cpu")
    assert set(acc) == set(DTYPES)
    assert "kernel_vs_3pass" in acc["f32"]
    for dtype, readings in acc.items():
        max_tol, mean_tol = TOL[("plain", dtype)]
        assert readings["kernel_vs_plain"] == (0.0, 0.0)
        assert readings["kernel_vs_f64"] == readings["plain_vs_f64"]
        assert (readings["plain_vs_f64"][0] <= max_tol
                and readings["plain_vs_f64"][1] <= mean_tol)
        assert readings["control_vs_plain"][1] > 10 * mean_tol


@pytest.mark.parametrize("seed", SEEDS)
def test_normalise_without_division_is_ieee(seed):
    """The kernel's y / peak without a division: with inv = RN(1 / peak),
    q = RN(v inv) corrected by RN(q + RN(v - q peak) inv) (the FMA's
    remainder is exact) equals the IEEE quotient for every |v| <= peak,
    here for random v and v a few bits wide. Emulated in float64, where the
    products are exact, so each step rounds once to float32 but the last
    sum, whose double rounding could only make this test fail."""
    rng = np.random.default_rng(seed)
    n = 1_000_000
    peak = (rng.uniform(1.0, 2.0, n)
            * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    v = (peak * rng.uniform(-1.0, 1.0, n)).astype(np.float32)
    short = (np.round(v.astype(np.float64) / peak * 1024) / 1024
             * peak).astype(np.float32)
    v, peak = np.concatenate([v, short]), np.concatenate([peak, peak])
    v64, p64 = v.astype(np.float64), peak.astype(np.float64)
    inv = (1.0 / p64).astype(np.float32).astype(np.float64)
    q = (v64 * inv).astype(np.float32).astype(np.float64)
    rem = (v64 - q * p64).astype(np.float32).astype(np.float64)
    got = (q + rem * inv).astype(np.float32)
    np.testing.assert_array_equal(got, (v64 / p64).astype(np.float32))


# Kernel vs plain version on the card, (max, mean) |diff| after 10
# products, by batch: bf16, the same exact products summed by the tensor
# cores in their own order, so a sum near a rounding tie may land one bf16
# step (2^-8) away and carry on (measured max 0.0117 at B=1024, where more
# sums lie near a tie than at B=64, whose max is the CPU TOL's); the mean
# tells that from a store that truncates (`mxu_rate.truncated_chain`,
# ~1e-3); float32, the three-pass split and the tensor cores' summation
# order.
KERNEL_TOL = {64: {"bf16": (TOL[("plain", "bf16")][0], 2e-4),
                   "f32": TOL[("plain", "f32")]},
              1024: {"bf16": (2e-2, 2e-4), "f32": TOL[("plain", "f32")]}}
# The float32 kernel vs `tf32_chain`, its arithmetic in torch: the tensor
# cores sum the three passes in one accumulator, in their own order and
# rounding, against three float32 products summed after (measured max
# 3.5e-6 at B=1024 after 10 products on an H100); a split that lost its low
# parts would be ~1e-3 away.
THREE_PASS_TOL = 5e-6


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
    diff = (got.float() - want.float()).abs()
    max_tol, mean_tol = KERNEL_TOL[64][dtype]
    assert float(diff.max()) <= max_tol and float(diff.mean()) <= mean_tol


@pytest.mark.cuda
def test_accuracy_readings_on_card(cuda_device):
    """`mxu_rate.accuracy` at the benchmark's B=1024, 10 products: the
    kernel within KERNEL_TOL of the plain version and of the float64
    witness, each control outside it (or the limits have no teeth), the
    float32 kernel within THREE_PASS_TOL of `tf32_chain`."""
    acc = mxu_rate.accuracy(1024, 10, cuda_device)
    for dtype, readings in acc.items():
        max_tol, mean_tol = KERNEL_TOL[1024][dtype]
        for key in ("kernel_vs_plain", "kernel_vs_f64"):
            err, mean = readings[key]
            assert err <= max_tol and mean <= mean_tol, (dtype, key, err,
                                                         mean)
        err, mean = readings["control_vs_plain"]
        assert not (err <= max_tol and mean <= mean_tol), (dtype, err, mean)
    assert acc["f32"]["kernel_vs_3pass"][0] <= THREE_PASS_TOL


@pytest.mark.cuda
def test_measure_runs_the_kernel_on_card(cuda_device):
    """`mxu_rate.measure` launches K3 and no other kernel of the port."""
    from card_device import launches

    before = launches()
    mxu_rate.measure(1024, 10, reps=1, device=cuda_device)
    got = {k: v - before[k] for k, v in launches().items()}
    assert got["unrolled_dots"] > 0
    assert got["fused_admm"] == got["fused_full_solve"] == got["dense_qp"] \
        == 0


@pytest.mark.cuda
def test_f32_kernel_matches_three_passes_on_card(cuda_device):
    """The float32 kernel vs its arithmetic in torch ops (`tf32_chain`),
    B=64, 10 products, within THREE_PASS_TOL; and the plain TF32 chain of
    one pass is far outside it."""
    m = mxu_rate.problems(64, torch.float32, cuda_device)
    got = mxu_rate.unrolled_dots(m, 10)
    torch.cuda.synchronize()
    err = float((got - mxu_rate.tf32_chain(m, 10)).abs().max())
    assert err <= THREE_PASS_TOL
    assert float((got - mxu_rate.tf32_chain(m, 10, 1)).abs().max()) > 1e-4
