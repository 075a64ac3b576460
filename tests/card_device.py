"""The card's side of the port's tests. Imports no JAX.

A test that needs an NVIDIA GPU is marked `cuda` and gets the card from
`cuda_device` (a fixture) or `on(device)` (for a test parametrised over
DEVICES); without a card it skips there, so the CPU run collects every
such test and passes none of them. The card's machine has no JAX, and
tests/conftest.py imports it, so there every module that imports this
one runs without the conftest, four modules at a time:

    python -m pytest --noconftest -p no:cacheprovider -p xdist -n 4 \\
        --dist loadfile -m "cuda and not slow" \\
        $(grep -lE 'card_device|mark\\.cuda' tests/test_torch_*.py)

chip_smoke.py runs that command in its process, then times each kernel
alone (`benchmarks.kernels`), and prints the launches the tests counted.

tests/test_torch_imports.py holds those modules free of a module-level
JAX import.
"""

import pytest
import torch

# A test's device parameter: the CPU, and the card under the `cuda` mark.
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def cuda() -> torch.device:
    """The card, with TF32 off for every float32 product; skips the test
    without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels and "
                    "graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def on(device: str):
    """The device a DEVICES parameter names: "cpu", or the card."""
    return "cpu" if device == "cpu" else cuda()


@pytest.fixture
def cuda_device() -> torch.device:
    return cuda()


@pytest.fixture(autouse=True)
def launch_record(request):
    """Puts the kernels a test launched (`since`), where it launched any,
    in its report's `user_properties` under "launches", from which
    chip_smoke.py sums each kernel's launches over the card's tests.
    Active in each module that imports it."""
    before = launches()
    yield
    got = since(before)
    if any(got.values()):
        request.node.user_properties.append(("launches", got))


def launches() -> dict:
    """Each kernel wrapper's launches so far, by kernel."""
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.solvers import (cone_qp, fused_admm,
                                             fused_full_solve, qp)

    return {"fused_admm": fused_admm.fused_admm.launches,
            "newton_schulz_inverse":
                cone_qp.newton_schulz_inverse.launches,
            "fused_full_solve": fused_full_solve.fused_full_solve.launches,
            "unrolled_dots": mxu_rate.unrolled_dots.launches,
            "dense_qp": qp.admm_solve.launches}


def count_qps(monkeypatch) -> dict:
    """The QPs the callers of `qp.admm_solve` ask for from here on, by
    caller, counted through `monkeypatch` (pytest's fixture or a
    `pytest.MonkeyPatch`): `wbc_step` one a call, the force balance's
    `polish.solve_factored` one a call, the pose planner's
    `plan_target_pose_sqp` one a SQP step; the SQP's calls also under
    "sqp_calls", and the MPC solves (`cone_qp.solve` calls, each one K1
    launch and one of the inverse's kernel on the card) under "solves"."""
    import inspect

    from quadruped_tpu_torch.control import wbc
    from quadruped_tpu_torch.planner import pose_planner
    from quadruped_tpu_torch.solvers import cone_qp, polish

    sqp = pose_planner.plan_target_pose_sqp
    sqp_iters = inspect.signature(sqp).parameters["sqp_iters"].default
    asked = {"wbc_step": 0, "solve_factored": 0, "sqp_steps": 0,
             "sqp_calls": 0, "solves": 0}

    def counted(module, attr, key, qps):
        inner = getattr(module, attr)

        def wrapper(*a, **k):
            asked[key] += qps(k)
            if key == "sqp_steps":
                asked["sqp_calls"] += 1
            return inner(*a, **k)

        monkeypatch.setattr(module, attr, wrapper)

    counted(wbc, "wbc_step", "wbc_step", lambda k: 1)
    counted(polish, "solve_factored", "solve_factored", lambda k: 1)
    counted(pose_planner, "plan_target_pose_sqp", "sqp_steps",
            lambda k: k.get("sqp_iters", sqp_iters))
    counted(cone_qp, "solve", "solves", lambda k: 1)
    return asked


def since(before: dict) -> dict:
    """The kernels launched since `before` (a `launches()`), by kernel."""
    return {k: v - before[k] for k, v in launches().items()}


def expected(asked: dict, k1: int, inverses: int | None = None) -> dict:
    """The launches of a path that ran `k1` MPC solves and the QPs
    `asked` (`count_qps`): K1 once a solve, the Newton-Schulz inverse's
    kernel `inverses` times (default: once a solve, each solve's cold
    inverse) and no other MPC kernel, the dense-QP kernel once a QP."""
    if inverses is None:
        inverses = k1
    return {"fused_admm": k1, "newton_schulz_inverse": inverses,
            "fused_full_solve": 0, "unrolled_dots": 0,
            "dense_qp": asked["wbc_step"] + asked["solve_factored"]
            + asked["sqp_steps"]}


def assert_launches(before: dict, asked: dict, k1: int,
                    inverses: int | None = None) -> dict:
    """The kernels launched since `before` are `expected(asked, k1,
    inverses)`; returns them."""
    got = since(before)
    assert got == expected(asked, k1, inverses), (got, asked)
    return got
