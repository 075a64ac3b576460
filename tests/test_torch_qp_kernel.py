"""The dense-QP kernel (csrc/dense_qp.cu) behind solvers/qp.py::admm_solve.

* On the CPU: CPU tensors take the plain version `admm_solve_reference`,
  bit for bit, and launch nothing; the operand checks the wrapper makes
  before it reaches a card (on meta tensors); the WBC's batch-shared cost
  stays a stride-0 view, and leading batch axes flatten into one.
* On the card (marker `cuda`): the kernel against `admm_solve_reference` on
  the same card and operands, at the three callers' shapes: the WBC's own
  QPs (`benchmarks/wbc.py::qp_problems`, B=4096: 18 variables, 30 rows,
  trot pairs and full stance, pinned force rows, +-1e8 bounds, 50
  iterations), the force-balance polish's whitened QP
  (`solvers/polish.py::solve_factored`: identity cost, unit rows of
  A [20, 12], scale=False, rho given, warm x0) and the pose planner's SQP
  step (`planner/pose_planner.py`: 6 variables, 12 rows), each output
  held to a float64 run of the plain arithmetic as closely as the plain
  version is, problem by problem in quantiles, at the callers' iteration
  budgets and at a short one; random QPs at shapes no caller has (n <= 3,
  the widest n = 20 and m = 32, a float rho, a warm (x0, y0)); one launch
  a call; the same bits from run to run; leading axes; a bad shape and a
  float64 operand raise.
* On the CPU too: the controls (fewer iterations or Newton steps) fail
  the bound the card tests hold the kernel to, the plain CPU run standing
  in for the kernel. This module imports no JAX:
      python -m pytest --noconftest -p no:cacheprovider -m cuda \
          tests/test_torch_qp_kernel.py
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from card_device import cuda_device  # noqa: F401
from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
from quadruped_tpu_torch.core import linalg
from quadruped_tpu_torch.solvers import qp

torch.set_num_threads(1)

FIELDS = qp.QPSolution._fields


def _random_qp(batch, n, m, seed, eq_rows=2):
    """A batch of random convex QPs with `eq_rows` equality rows and one
    row unbounded above (+1e8)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(batch, n, n))
    p = g @ g.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    a = rng.normal(size=(batch, m, n))
    lo = -rng.uniform(0.1, 1.0, (batch, m))
    hi = rng.uniform(0.1, 1.0, (batch, m))
    lo[:, :eq_rows] = hi[:, :eq_rows]
    hi[:, -1] = 1e8
    out = [p, rng.normal(size=(batch, n)), a, lo, hi]
    return [torch.as_tensor(x, dtype=torch.float32) for x in out]


CPU_CASES = {
    "scaled-default_rho": lambda b, n, m: {},
    "unscaled-rho_vector-warm_x": lambda b, n, m: {
        "scale": False, "rho": torch.full((b, m), 0.3),
        "x0": torch.full((b, n), 0.1)},
    "scaled-float_rho-warm_xy": lambda b, n, m: {
        "rho": 0.2, "x0": torch.full((b, n), -0.1),
        "y0": torch.full((b, m), 0.05)},
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_cpu_tensors_take_the_plain_path(case):
    args = _random_qp(5, 18, 30, seed=1)
    kw = dict(CPU_CASES[case](5, 18, 30), iters=20)
    before = qp.admm_solve.launches
    got = qp.admm_solve(*args, **kw)
    want = qp.admm_solve_reference(*args, **kw)
    assert qp.admm_solve.launches == before == 0
    for name, g, w in zip(FIELDS, got, want):
        assert torch.equal(g, w), name


def _meta(shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype, device="meta") for s in shapes]


# The operands by shape (p, q, a, l, u) and the error each must raise.
BAD = {
    "m_33": ([(4, 18, 18), (4, 18), (4, 33, 18), (4, 33), (4, 33)],
             torch.float32, ValueError),
    "n_33": ([(4, 33, 33), (4, 33), (4, 30, 33), (4, 30), (4, 30)],
             torch.float32, ValueError),
    "n_21": ([(4, 21, 21), (4, 21), (4, 9, 21), (4, 9), (4, 9)],
             torch.float32, ValueError),
    "float64": ([(4, 18, 18), (4, 18), (4, 30, 18), (4, 30), (4, 30)],
                torch.float64, TypeError),
    "a_columns": ([(4, 18, 18), (4, 18), (4, 30, 17), (4, 30), (4, 30)],
                  torch.float32, ValueError),
    "batch": ([(4, 18, 18), (3, 18), (4, 30, 18), (4, 30), (4, 30)],
              torch.float32, ValueError),
    "no_kernel_for_meta": ([(4, 18, 18), (4, 18), (4, 30, 18), (4, 30),
                            (4, 30)], torch.float32, ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_operand_checks_before_the_card(case):
    """What the wrapper refuses is refused before any launch: a device that
    is not the CPU runs the checks, then a device without the kernel
    raises too."""
    shapes, dtype, error = BAD[case]
    with pytest.raises(error):
        qp.admm_solve(*_meta(shapes, dtype), iters=3)
    assert qp.admm_solve.launches == 0


def test_shared_cost_stays_a_view():
    """The WBC's diagonal cost, one [18, 18] expanded over the batch, goes
    to the kernel with batch stride 0 and no copy; the other operands keep
    their layout."""
    args, _ = bench_wbc.qp_problems(6, "cpu")
    batch, ops = qp._kernel_operands(*args, None, None, None)
    assert batch == (6,)
    assert ops[0].stride(0) == 0
    assert ops[0].data_ptr() == args[0].data_ptr()
    for op, arg in zip(ops[1:5], args[1:]):
        assert op.data_ptr() == arg.data_ptr() and op.is_contiguous()
    assert ops[5] is ops[6] is ops[7] is None


def test_leading_axes_flatten():
    """[2, 3] leading axes, a P shared by every problem, a rho of shape
    [m], a 0-dim rho and a float rho broadcast to [6, m] rows."""
    p, q, a, l, u = _random_qp(6, 6, 12, seed=2)
    q, a, l, u = (t.reshape((2, 3) + t.shape[1:]) for t in (q, a, l, u))
    for rho in (torch.full((12,), 0.4), torch.tensor(0.4), 0.4):
        batch, ops = qp._kernel_operands(p[0], q, a, l, u, rho, None, None)
        assert batch == (2, 3)
        assert [tuple(t.shape) for t in ops[:6]] == [
            (6, 6, 6), (6, 6), (6, 12, 6), (6, 12), (6, 12), (6, 12)]
        assert ops[0].stride(0) == 0
        assert torch.equal(ops[5], torch.full((6, 12), 0.4))


def test_the_wbc_qps_mix_stance_and_swing():
    """The WBC problems of `qp_problems`: 18 x 30, a shared diagonal cost,
    6 dynamics equalities on every row plus 12 pinned rows on the trot
    rows, friction rows open to +1e8."""
    (p, q, a, l, u), kw = bench_wbc.qp_problems(8, "cpu")
    assert tuple(a.shape) == (8, 30, 18) and kw == {"iters": 50}
    eq = ((u - l) < 1e-9).sum(-1)
    assert eq.tolist() == [18, 6] * 4
    assert float(u.max()) == 1e8
    assert torch.equal(p[0], p[7]) and p.stride(0) == 0


# --- the callers' QPs and the bound -----------------------------------------


def _wbc_qp(dev, b):
    return bench_wbc.qp_problems(b, dev, seed=3)


def _polish_qp(dev, b):
    """The whitened QP of `solve_factored` inside
    `compute_contact_forces` (VELOCITY mode's force balance, warm from
    30 N a stance leg) on random A1 stance states at a trot's errors, two
    or four legs in contact (swing rows pinned)."""
    from quadruped_tpu_torch.control import stance_force_balance as sfb
    from quadruped_tpu_torch.control.desired_state import DesiredStateCommand
    from quadruped_tpu_torch.control.types import RobotObservation
    from quadruped_tpu_torch.core import se3
    from quadruped_tpu_torch.robots import a1_params

    rng = np.random.default_rng(4)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)

    rpy = rng.uniform(-0.05, 0.05, (b, 3))
    rpy[:, 2] = rng.uniform(-np.pi, np.pi, b)
    quat = se3.rpy_to_quat(f32(rpy))
    rot = se3.quat_to_rotmat(quat)
    omega_w = f32(rng.normal(size=(b, 3)) * 0.1)
    contacts = np.ones((b, 4))
    contacts[0::2] = np.where((rng.random((b + 1) // 2) < 0.5)[:, None],
                              [1, 0, 0, 1], [0, 1, 1, 0])
    obs = RobotObservation(
        base_position=f32(np.c_[rng.normal(size=(b, 2)) * 0.05,
                                0.27 + rng.normal(size=b) * 0.01]),
        base_rpy=f32(rpy), base_quat=quat,
        base_vel_world=f32(rng.normal(size=(b, 3)) * 0.1),
        base_omega_world=omega_w,
        base_omega_body=torch.einsum("bj,bji->bi", omega_w, rot),
        joint_angles=f32(np.tile([0.0, 0.67, -1.25], 4)
                         + rng.normal(size=(b, 12)) * 0.05),
        joint_velocities=f32(rng.normal(size=(b, 12))),
        foot_contact=f32(contacts), foot_forces=f32(np.zeros((b, 4))))
    des = DesiredStateCommand(
        position=f32(np.c_[rng.normal(size=(b, 2)) * 0.02,
                           np.full(b, 0.27)]),
        rpy=f32(np.c_[rng.uniform(-0.03, 0.03, (b, 2)), np.zeros(b)]),
        velocity=f32(np.c_[rng.uniform(0.0, 0.4, b),
                           rng.uniform(-0.1, 0.1, b), np.zeros(b)]),
        omega=f32(np.c_[np.zeros((b, 2)), rng.uniform(-0.2, 0.2, b)]),
        filtered_linear=f32(np.zeros((b, 3))), filtered_wz=f32(np.zeros(b)))
    warm = f32(np.tile([0.0, 0.0, 30.0], (b, 4, 1)) * contacts[..., None])
    return bench_wbc.capture_qp(lambda: sfb.compute_contact_forces(
        sfb.ForceBalanceConfig(), a1_params(dev), obs, des, f32(contacts),
        x_warm=warm))


def _planner_qp(dev, b):
    """The pose planner's first SQP step on random stance configurations
    (3 or 4 contacts, slopes up to 0.1 rad)."""
    from quadruped_tpu_torch.planner import pose_planner as pp
    from quadruped_tpu_torch.robots import a1_params

    rng = np.random.default_rng(5)
    feet = (np.array([[0.17, -0.13, 0.0], [0.17, 0.13, 0.0],
                      [-0.17, -0.13, 0.0], [-0.17, 0.13, 0.0]])[None]
            + rng.normal(0.0, 0.02, (b, 4, 3)))
    slope = rng.uniform(-0.1, 0.1, b)
    feet[..., 2] -= feet[..., 0] * np.tan(slope)[:, None]
    support = np.ones((b, 4))
    drop = rng.integers(0, 5, b)
    support[np.arange(b)[drop < 4], drop[drop < 4]] = 0.0
    base = np.stack([rng.normal(0, 0.02, b), rng.normal(0, 0.02, b),
                     0.27 + rng.normal(0, 0.01, b)], -1)
    ground = np.stack([np.zeros(b), slope, np.zeros(b)], -1)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return bench_wbc.capture_qp(lambda: pp.plan_target_pose_sqp(
        a1_params(dev), f32(base), f32(rng.normal(0.0, 0.03, (b, 3))),
        f32(feet), f32(support), f32(ground), 0.27))


QPS = {"wbc": _wbc_qp, "polish": _polish_qp, "planner": _planner_qp}
CARD_BATCH, CPU_BATCH = 4096, 1024


@functools.lru_cache(maxsize=None)
def _qp(name, dev, batch):
    return QPS[name](torch.device(dev), batch)


# How close, on one card. The kernel and the plain version sum every
# product in another order (the kernel four partial sums a mat-vec and in
# order of k in the inverse; the plain version cuBLAS's and torch's
# orders); nothing else differs. On the WBC's and the polish's QPs that
# change of order moves the float32 result as far as float32 itself lies
# from float64 (the equality rows' 1000x rho leave M ~1e3-1e4 from
# singular, and the inverse's error shifts the ADMM iterate one for one):
# the plain version reads up to 9.8e-3 in x from a float64 run of the same
# arithmetic on the WBC's QPs (5.5% of problems beyond K1's 1e-3 + 1e-4
# |x|), the kernel 9.1e-3, and the two 1.8e-2 from each other (H100,
# B=4096). So each output of the kernel is held to the float64 run problem
# by problem: at each of QUANTILES of the problems' largest errors, the
# kernel's at most FACTOR times the plain version's plus FLOOR (float32's
# resolution at the planner's |x| <= 0.2). The median catches a fault on
# the well-conditioned problems, the maximum one on the worst few.
FACTOR, FLOOR = 2.0, 1e-6
QUANTILES = (0.5, 0.9, 0.99, 1.0)
SHORT_ITERS = 5


@contextlib.contextmanager
def _newton_steps(k):
    """The plain version's inverse with k Newton steps in place of two."""
    inv = linalg.inv_spd

    def fewer(m, refine=2):
        return inv(m, refine=k)

    linalg.inv_spd = fewer
    try:
        yield
    finally:
        linalg.inv_spd = inv


def _plain(args, kw, iters=None, newton=2):
    with _newton_steps(newton) if newton != 2 else contextlib.nullcontext():
        return qp.admm_solve_reference(
            *args, **dict(kw, iters=kw["iters"] if iters is None else iters))


# The controls, each a fault the kernel must not have: the plain version
# with fewer iterations or Newton steps. Each caller's list holds those the
# bound refuses on its QPs (the tests below check that it does, on the CPU
# and on the card). Not in a list, because float32 cannot tell them from
# the contract there: 40 of the WBC's 50 iterations and one Newton step on
# the WBC's and the planner's QPs (the iterate has settled, and one step
# leaves M^-1 as exact as float32 holds it, to within the spread of two
# summation orders); no Newton step on the planner's 6 x 6. One iteration
# fewer at the short budget fails on every caller's QPs, so the kernel is
# shown to run as many iterations as it is asked; one Newton step fails on
# the polish's, so it is shown to take both.
CONTROLS = {
    "iters_10": lambda args, kw: _plain(args, kw, iters=10),
    "iters_minus_10": lambda args, kw: _plain(args, kw, kw["iters"] - 10),
    "one_newton_step": lambda args, kw: _plain(args, kw, newton=1),
    "no_newton_step": lambda args, kw: _plain(args, kw, newton=0),
    "one_iteration_fewer": lambda args, kw: _plain(args, kw,
                                                   kw["iters"] - 1),
}
CALLER_CONTROLS = {
    "wbc": ("iters_10", "no_newton_step"),
    "polish": ("iters_10", "iters_minus_10", "one_newton_step",
               "no_newton_step"),
    "planner": ("iters_10", "iters_minus_10"),
}
SHORT_CONTROLS = ("one_iteration_fewer",)


def _float64(args, kw):
    return qp.admm_solve_reference(
        *(t.double() for t in args),
        **{k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()})


def _quantiles(sol, ref) -> dict:
    """{output: its problems' largest |sol - ref| at QUANTILES}."""
    q = torch.tensor(QUANTILES, dtype=torch.float64, device=ref.x.device)
    out = {}
    for f in FIELDS:
        d = (getattr(sol, f).double() - getattr(ref, f)).abs()
        out[f] = torch.quantile(d.reshape(d.shape[0], -1).amax(-1), q)
    return out


def _over(err: dict, limit: dict) -> dict:
    """{output: quantiles at which err passes limit}."""
    out = {f: [q for q, e, lim in zip(QUANTILES, err[f].tolist(),
                                      limit[f].tolist()) if not e <= lim]
           for f in FIELDS}
    return {f: qs for f, qs in out.items() if qs}


def _assert_as_close_as_plain(label, args, kw, got, controls):
    """The solution `got` held to the float64 run as the plain version is
    (FACTOR, FLOOR at each of QUANTILES), and each named control failing
    that bound."""
    ref = _float64(args, kw)
    for f, g in zip(FIELDS, got):
        assert torch.isfinite(g).all(), f
    plain = _quantiles(_plain(args, kw), ref)
    limit = {f: FACTOR * e + FLOOR for f, e in plain.items()}
    err = _quantiles(got, ref)
    ctl = {c: _quantiles(CONTROLS[c](args, kw), ref) for c in controls}
    print(label, tuple(args[2].shape), kw["iters"], "plain",
          {f: e.tolist() for f, e in plain.items()}, "solve",
          {f: e.tolist() for f, e in err.items()},
          {c: {f: e.tolist() for f, e in q.items()} for c, q in ctl.items()})
    assert not _over(err, limit), (_over(err, limit), err, limit)
    for c, q in ctl.items():
        assert _over(q, limit), (c, q, limit)


CPU_CASES_BOUND = (
    [(name, c, "full") for name, cs in CALLER_CONTROLS.items() for c in cs]
    + [(name, c, "short") for name in QPS for c in SHORT_CONTROLS])


@pytest.mark.parametrize("name,control,budget", CPU_CASES_BOUND,
                         ids=[f"{n}-{b}-{c}" for n, c, b in CPU_CASES_BOUND])
def test_the_bound_refuses_each_control_on_the_cpu(name, control, budget):
    """The plain CPU run stands in for the kernel: it meets the bound, and
    the control does not."""
    args, kw = _qp(name, "cpu", CPU_BATCH)
    if budget == "short":
        kw = dict(kw, iters=SHORT_ITERS)
    _assert_as_close_as_plain(f"cpu:{name}:{budget}", args, kw,
                              _plain(args, kw), (control,))


# --- on the card -----------------------------------------------------------


# (caller, batch): each caller's QPs at CARD_BATCH, and the WBC's at the
# Aliengo sweep's batch.
CARD_CASES = [(name, CARD_BATCH) for name in QPS] + [("wbc", 131072)]
CARD_IDS = [f"{name}-b{batch}" if batch != CARD_BATCH else name
            for name, batch in CARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", CARD_CASES, ids=CARD_IDS)
def test_kernel_matches_plain_on_card(cuda_device, name, batch):
    args, kw = _qp(name, "cuda", batch)
    before = qp.admm_solve.launches
    got = qp.admm_solve(*args, **kw)
    assert qp.admm_solve.launches == before + 1
    _assert_as_close_as_plain(name, args, kw, got, CALLER_CONTROLS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", CARD_CASES, ids=CARD_IDS)
def test_kernel_runs_every_iteration_on_card(cuda_device, name, batch):
    """At SHORT_ITERS each iteration still moves the iterate far beyond
    float32's noise: the kernel meets the bound there and the plain version
    one iteration short does not."""
    args, kw = _qp(name, "cuda", batch)
    kw = dict(kw, iters=SHORT_ITERS)
    _assert_as_close_as_plain(f"{name}:short", args, kw,
                              qp.admm_solve(*args, **kw), SHORT_CONTROLS)


# Shapes no caller has: the closed forms alone (n <= 3), the smallest
# Schur recursion, odd sizes, the widest problem (n = 20, m = 32) with a
# float rho and a warm (x0, y0). No equality row: on random rows a 1000x
# rho makes M (cond ~1e4) hard enough for the unpivoted block-Schur seed
# that the plain version, as the JAX package's, lies up to ~10 from
# float64 on some of 1024 problems; the callers' equality rows are the
# WBC's and the polish's above.
RANDOM_SHAPES = {"n1_m2": (1, 2, {}), "n2_m3": (2, 3, {}),
                 "n3_m5": (3, 5, {}), "n4_m4": (4, 4, {}),
                 "n7_m11": (7, 11, {"scale": False}),
                 "n20_m32-float_rho-warm": (20, 32, {"rho": 0.2,
                                                     "warm": True})}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANDOM_SHAPES))
def test_kernel_on_random_shapes(cuda_device, case):
    n, m, opts = RANDOM_SHAPES[case]
    args = [t.to(cuda_device) for t in _random_qp(1024, n, m, seed=n + m,
                                                   eq_rows=0)]
    kw = {"iters": 60, **{k: v for k, v in opts.items() if k != "warm"}}
    if opts.get("warm"):
        kw["x0"] = torch.full((1024, n), 0.1, device=cuda_device)
        kw["y0"] = torch.full((1024, m), -0.05, device=cuda_device)
    _assert_as_close_as_plain(case, args, kw, qp.admm_solve(*args, **kw),
                              ("iters_10",))


@pytest.mark.cuda
def test_kernel_is_the_same_bits_run_to_run(cuda_device):
    args, kw = _qp("wbc", "cuda", CARD_BATCH)
    first = qp.admm_solve(*args, **kw)
    second = qp.admm_solve(*args, **kw)
    for f, a, b in zip(FIELDS, first, second):
        assert torch.equal(a, b), f


@pytest.mark.cuda
def test_leading_axes_on_card(cuda_device):
    """[2, 2048] leading axes give the flat batch's numbers."""
    args, kw = _qp("wbc", "cuda", CARD_BATCH)
    flat = qp.admm_solve(*args, **kw)
    shaped = qp.admm_solve(*(t.reshape((2, 2048) + t.shape[1:])
                             for t in args), **kw)
    for f, a, b in zip(FIELDS, flat, shaped):
        assert torch.equal(a, b.reshape(a.shape)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m_33", "n_21", "float64"])
def test_bad_operands_raise_on_card(cuda_device, case):
    shapes, dtype, error = BAD[case]
    ops = [torch.zeros(s, dtype=dtype, device=cuda_device) for s in shapes]
    before = qp.admm_solve.launches
    with pytest.raises(error):
        qp.admm_solve(*ops, iters=3)
    assert qp.admm_solve.launches == before
