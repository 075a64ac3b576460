"""The MPC's Newton-Schulz inverse, `cone_qp.newton_schulz_inverse`: its
route by device and shape, and its kernel (csrc/newton_schulz.cu). Imports
no JAX.

On the CPU (tier-1): the route returns bit for bit the plain version as
the benchmark's frozen reference has it (`portbench/reference/cone_qp.py`),
the input checks raise, and the kernel's layout (`cone_qp.ns_layout`)
fits the shared memory it is sized for. On the card (`cuda`): the kernel
against the plain version (`newton_schulz_inverse_reference`, torch ops on
the card, TF32 off), bit for bit, and a float64 inverse on the update's,
the Aliengo's and edge-shaped M, one launch a call, and n = 192 through
the torch ops.
"""

import pytest
import torch

from card_device import cuda_device, launch_record  # noqa: F401
from portbench.reference import cone_qp as frozen
from quadruped_tpu_torch.robots import aliengo_params
from quadruped_tpu_torch.solvers import cone_qp, problems

# Shared memory of one H100 SM and the most one block may take (bytes),
# and what the CUDA runtime keeps back a block.
SM_SMEM = 233_472
BLOCK_SMEM = 232_448
RESERVED = 1024


def bench_m(batch: int, horizon: int, device) -> torch.Tensor:
    """M of `bench_problems` (the update's draw) at n = 12 horizon."""
    prob, _ = problems.bench_problems(batch, horizon=horizon, device=device)
    m, _ = cone_qp.admm_operands(prob, cone_qp.RHO_CONE, cone_qp.SIGMA,
                                 None, None)
    return m


def aliengo_m(batch: int, device) -> torch.Tensor:
    """M of the Aliengo's MPC at H = 5 (n = 60), `mpc_problem` through the
    boot of standing Aliengos."""
    prob, x0, _ = problems.boot_problems(batch, horizon=5, device=device,
                                         robot=aliengo_params)
    m, _ = cone_qp.admm_operands(prob, cone_qp.RHO_CONE, cone_qp.SIGMA, x0,
                                 None)
    return m


def padded_tail_m(batch: int, device) -> torch.Tensor:
    """The update's M at n = 120 with its last 24 rows and columns zero but
    for a unit diagonal: a live block of 96 inside a zero-padded tail."""
    m = bench_m(batch, 10, device).clone()
    m[:, 96:, :] = 0.0
    m[:, :, 96:] = 0.0
    m[:, 96:, 96:] = torch.eye(24, device=device)
    return m


# ---------------------------------------------------------------- CPU ---

@pytest.mark.parametrize("polish", [1, 2])
@pytest.mark.parametrize("n", [24, 60, 120])
def test_cpu_route_is_the_plain_version(n, polish):
    """A CPU tensor takes the torch ops: the frozen plain version's result
    bit for bit, and no kernel launch."""
    m = bench_m(4, n // 12, "cpu")
    before = cone_qp.newton_schulz_inverse.launches
    got = cone_qp.newton_schulz_inverse(m, cone_qp.NS_ITERS, polish)
    assert torch.equal(got, frozen.newton_schulz_inverse(
        m, cone_qp.NS_ITERS, polish))
    assert cone_qp.newton_schulz_inverse.launches == before


BAD_INPUTS = {
    "float64": (lambda m: m.double(), TypeError),
    "not contiguous": (lambda m: m.transpose(1, 2), ValueError),
    "not square": (lambda m: m[:, :, :12], ValueError),
    "n not 12 G": (lambda m: m[:, :18, :18].contiguous(), ValueError),
    "n over the tile": (lambda m: torch.zeros(2, 132, 132), ValueError),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_input_checks_raise(case):
    """`check_inverse_input`, which a CUDA tensor passes before its
    launch, raises on what the kernel does not take; a good M passes."""
    m = bench_m(2, 2, "cpu")
    cone_qp.check_inverse_input(m)
    make, error = BAD_INPUTS[case]
    with pytest.raises(error):
        cone_qp.check_inverse_input(make(m))


@pytest.mark.parametrize("batch, n, split", [
    (1, 120, 8), (1, 60, 4), (1, 24, 8), (65536, 120, 8), (131071, 60, 4),
    (2, 120, 0), (65535, 120, 0), (65537, 120, 0), (131072, 60, 0),
    (1, 12, 0)])
def test_lone_split(batch, n, split):
    """cuBLAS's split-K order is taken for the last problem where cuBLAS
    multiplies it alone (B = 1 mod 65535), at the n its order is known
    for; every other problem is one chain."""
    assert cone_qp.lone_split(batch, n) == split


@pytest.mark.parametrize("n", list(range(12, 129, 12)))
def test_layout_fits(n):
    """The 64 tile for n <= 64, else 128; ld a multiple of 4 from n whose
    row groups' A reads fall in distinct banks; the three float32 buffers
    within one block's shared memory, and five blocks an SM at the
    Aliengo's n = 60."""
    tile, ld, smem = cone_qp.ns_layout(n)
    assert tile == (64 if n <= 64 else 128)
    assert ld >= n and ld % 4 == 0
    assert len({(r * ld) % 32 for r in range(8)}) == 8
    assert smem == 3 * n * ld * 4 <= BLOCK_SMEM
    if n <= 60:
        assert 5 * (smem + RESERVED) <= SM_SMEM


# --------------------------------------------------------------- card ---

# {case: (M as a function of the device, iterations, float32 polish steps)}
CARD_CASES = {
    "update-b8192-n120": (lambda d: bench_m(8192, 10, d), 11, 1),
    "aliengo-b8192-n60": (lambda d: aliengo_m(8192, d), 11, 1),
    "b1-n120": (lambda d: bench_m(1, 10, d), 11, 1),
    "b2-n120": (lambda d: bench_m(2, 10, d), 11, 1),
    "b1-n60": (lambda d: aliengo_m(1, d), 11, 1),
    "b1-n24": (lambda d: bench_m(1, 2, d), 11, 1),
    "b2048-n12": (lambda d: bench_m(2048, 1, d), 11, 1),
    "b2048-n24": (lambda d: bench_m(2048, 2, d), 11, 1),
    "b2048-n72": (lambda d: bench_m(2048, 6, d), 11, 1),
    "padded-tail-b2048-n120": (lambda d: padded_tail_m(2048, d), 11, 1),
    "polish2-b2048-n120": (lambda d: bench_m(2048, 10, d), 11, 2),
    "polish0-b2048-n60": (lambda d: aliengo_m(2048, d), 11, 0),
    "lone-tail-b65536-n120": (lambda d: bench_m(2048, 10, d).repeat(32, 1, 1),
                              11, 1),
}


def readings(m: torch.Tensor, x: torch.Tensor, x64: torch.Tensor):
    """Per problem: max |I - M X| and max |X - X64| / max |X64|, float64."""
    m64, x = m.double(), x.double()
    eye = torch.eye(m.shape[-1], dtype=torch.float64, device=m.device)
    resid = (eye - m64 @ x).abs().amax(dim=(1, 2))
    dist = (x - x64).abs().amax(dim=(1, 2)) / x64.abs().amax(dim=(1, 2))
    return {"residual": resid, "distance": dist}


def stats(v: torch.Tensor) -> dict:
    q = torch.quantile(v, torch.tensor([0.5, 0.99], dtype=v.dtype,
                                       device=v.device))
    return {"median": q[0].item(), "p99": q[1].item(),
            "max": v.max().item()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """The plain version's result bit for bit (the kernel keeps cuBLAS's
    order of sums, a lone matrix's too), one launch a call; and, up to
    B=8192, the residual max |I - M X| and the distance to
    the float64 inverse within twice the plain version's plus 1e-6 at the
    median, the p99 and the max over the problems (the dense-QP kernel's
    rule, PERF.md §6)."""
    build, iters, polish = CARD_CASES[case]
    m = build(cuda_device)
    before = cone_qp.newton_schulz_inverse.launches
    x = cone_qp.newton_schulz_inverse(m, iters, polish)
    torch.cuda.synchronize()
    assert cone_qp.newton_schulz_inverse.launches == before + 1
    plain = cone_qp.newton_schulz_inverse_reference(m, iters, polish)
    assert torch.equal(x, plain), (x - plain).abs().max().item()
    if m.shape[0] > 8192:
        return
    x64 = torch.linalg.inv(m.double())
    got, ref = readings(m, x, x64), readings(m, plain, x64)
    for name in got:
        s_got, s_ref = stats(got[name]), stats(ref[name])
        for at in s_got:
            assert s_got[at] <= 2.0 * s_ref[at] + 1e-6, (name, at, s_got,
                                                         s_ref)


@pytest.mark.cuda
def test_large_n_takes_the_torch_ops_on_card(cuda_device):
    """n = 192 (the unblocked H = 16 MPC) is beyond the tile: the torch ops
    on the card, bit for bit, and no launch; inside the tile a bad input
    raises rather than falling back."""
    m = bench_m(256, 16, cuda_device)
    before = cone_qp.newton_schulz_inverse.launches
    got = cone_qp.newton_schulz_inverse(m, cone_qp.NS_ITERS, 1)
    assert torch.equal(got, cone_qp.newton_schulz_inverse_reference(
        m, cone_qp.NS_ITERS, 1))
    assert cone_qp.newton_schulz_inverse.launches == before
    small = bench_m(4, 10, cuda_device)
    with pytest.raises(TypeError):
        cone_qp.newton_schulz_inverse(small.double())
    with pytest.raises(ValueError):
        cone_qp.newton_schulz_inverse(small.transpose(1, 2))
    assert cone_qp.newton_schulz_inverse.launches == before
