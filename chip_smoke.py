"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  0. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 off for every float32 product;
  1. build: the three kernels of quadruped_tpu_torch/csrc, one nvcc each,
     all started together; each kernel's registers, spills and ptxas
     performance notes (-Xptxas -v), and its dynamic shared memory;
  2. fused_admm vs plain: the ADMM-loop kernel against its plain torch
     version on B=2048 H=10 MPC problems (the JAX solver benchmark's state
     and trot-table distribution), in the 400-iteration relaxed boot scheme
     and the 24-iteration warm Fast-ADMM scheme, with times of both, the
     kernel's achieved GB/s and its share of its bound; and on the boot
     solve the closed loop runs at unblocked H=16 (n = 192, 400 relaxed
     iterations, B=2048 standing robots, `problems.boot_problems`), held on
     the unscaled first-step forces within 1% m*g;
  3. the closed loop: `rollout_cadenced` for B=2048 A1 scenarios at the
     production MPC configuration, 18 MPC periods, commands
     vx ~ U(0.2, 0.8), wz ~ N(0, 0.2); fused_admm must be launched once per
     solve (1 boot + 18 periods), every state finite, and at least 99% of
     scenarios alive;
  4. fixture: the 4-scenario production-config rollout against the JAX
     package's output checked in at tests/data/rollout_cadenced_a1_h10.npz;
  5. fused_full_solve vs plain: the Newton-Schulz + ADMM kernel against its
     plain version at B=2048, n=120, H=10 and H=16 (move blocking (4, 2)),
     in both schemes: unscaled forces, the inverse's residual max|I - MX|,
     times of both, the inverse stage alone (a launch with iters=0), the
     achieved TFLOP/s of that stage and the kernel's share of its bound;
  6. unrolled_dots vs plain: the chained-product kernel against its plain
     version, bf16 and float32, B=1024, 10 products, in max and mean
     (`mxu_rate.accuracy`: beside it both chains against the chain summed
     in float64, a control that must fail the limits, and float32 against
     `mxu_rate.tf32_chain`, its three TF32 passes in torch ops), the
     kernel's load and store alone (no product), then the benchmark
     `mxu_rate.measure` through it;
  7. the MPC-update benchmark: `bench.build_bench` at B=8192 for H=10 and
     H=16 through the routes `loop` (fused_admm) and `full`
     (fused_full_solve): one kernel launch per update, the route's kernel
     against its plain version on the operands of that update (the limits
     of phases 2 and 5), the kernel's time, rate and share of its bound
     (K2 also its inverse stage alone, beside `torch.linalg.inv` on the same
     M as a yardstick the port never calls), solves/s, and the first-step
     forces of the two routes within 3% m*g of each other;
  8. the force-balance modes: `rollout` for B=2048 A1 scenarios in VELOCITY
     mode (TROT, ForceBalanceConfig(): 64 whitened-ADMM iterations, 24
     active-set polish passes, vx ~ U(0.1, 0.4), 100 ticks) and in
     POSITION mode
     (vx ~ U(0.0, 0.1)): at least 99% alive, every state finite, ms per
     tick and ticks/s, and over one more tick under torch.profiler the
     CUDA kernels per tick and the device's busy share; no kernel of the
     port launches in these modes (their QP is plain torch);
  9. fixture: the 4-scenario VELOCITY and POSITION rollouts against the JAX
     package's output checked in at tests/data/rollout_modes_a1.npz;
 10. the WBC: `wbc_step` on B=1024 states of the twin of the JAX
     benchmarks/bench_wbc.py (ms per tick, CUDA kernels per tick and the
     device's busy share; no kernel of the port launches, its QP is plain
     torch), then `rollout` with use_wbc at B=1024 (A1, ADVANCED_TROT,
     `MpcConfig(horizon=10)`, `WbcConfig()`, 400 ticks, vx ~ U(0.2, 0.6)):
     fused_admm launched once per MPC solve (1 boot + 50), the WBC called on
     its 150 ticks (every 2nd, never on a solve tick), at least 99% alive,
     every state finite, ms per tick, ticks/s, kernels per tick and busy
     share;
 11. the whole-body closed loop (the twin of the JAX
     benchmarks/bench_whole_body.py): B=1024, 300 ticks (the JAX benchmark
     times 500), fused_admm once per solve (1 boot + 38), at least 99%
     alive and every alive scenario's final height in [0.2, 0.35] m,
     ticks/s and simulator instances replaced (ticks/s / 500), kernels per
     tick and busy share; then the
     cross-simulator check (the twin of the JAX
     test_whole_body_trot_matches_srb) at B=64: the SRB `rollout` and the
     whole-body loop at `MpcConfig(horizon=5, qp_iters=24,
     qp_cold_iters=120)`, vx = 0.25, 600 ticks (the JAX test runs 1000),
     agreeing over ticks 400-600 on mean height within 3 cm and mean vx
     within 0.15 m/s;
 12. fixtures: the 4-scenario use_wbc rollout and the WBC outputs of the
     B=8 benchmark states against tests/data/rollout_wbc_a1.npz, the
     4-scenario whole-body loop against tests/data/whole_body_a1.npz;
 13. the statically-stable walk (the twin of the JAX
     benchmarks/bench_walk.py, benchmarks/walk.py): B=256 on the whole-body
     sim, 320 ticks (past the first TRUE_SWING entry, tick 308): at least
     99% alive, every state finite, at most one leg in TRUE_SWING per
     scenario on every tick, every leg that left its unload window swung,
     no kernel of the port launched (the walk's QPs are plain torch), the
     pose SQP run on the replan ticks only (counted); ms per tick, ticks/s,
     robot-seconds per wall second, and kernels per tick and busy share
     over a replan tick and a normal tick;
 14. online gait transitions: the trot -> walk -> trot sequence of the JAX
     test_closed_loop_trot_walk_trot (400 + 400 + 1000 + 400 + 900 ticks,
     ADVANCED_TROT with the 0.45 s walk table as `gait_b`) at B=64, vx ~
     U(0.15, 0.35), `gait_switch` raised in different segments per
     scenario (rows 0-3: the fixture's scenarios): at least 99% alive,
     fused_admm once per MPC solve (1 boot + 388), every scenario ending in
     phase NONE on the table its switch edges lead to, at most two legs
     unloaded on the walk table; ms per tick and kernels per tick;
 15. fixtures: the walk windows of tests/data/walk_a1.npz (the JAX flat
     walk, stair climb and gap crossing resumed from checkpoints; the
     first 60 of each window's 120 ticks) and rows 0-3 of phase 14 against
     tests/data/gait_transition_a1.npz, at the CPU tests' limits;
 16. the robot runner (quadruped_tpu_torch/benchmarks/runner.py, the twin
     of the JAX test_standup_then_estimated_trot): B=1024 A1 robots boot
     sitting on the whole-body sim and run 200 ticks of the FSM's STAND_UP
     ramp on estimates from noisy sensors (noise level 1, a
     torch.Generator): fused_admm launched once (the boot solve; the ramp
     shortcut skips the locomotion step), then 20 ramp ticks without the
     shortcut, once per tick; every state finite, every scenario in
     STAND_UP; ms per tick, ticks/s, robot-seconds per wall second, and
     over one tick kernels and busy share;
 17. the runner through the switch: the fixture's checkpoint 100 ticks
     before STAND_UP -> LOCOMOTION, tiled to B=1024, vx ~ U(0.15, 0.3),
     noise from a torch.Generator, 250 ticks: every scenario switches on
     the fixture's tick, at least 99% alive with final heights in [0.2,
     0.35] m, the mean |v_est - v_true| over LOCOMOTION ticks below the JAX
     test's 0.15 m/s, fused_admm once per MPC solve (19); times and
     profile over one 8-tick cycle;
 18. the RC channel: the ground-truth runner on the SRB sim at B=2048 with
     `rc_update`, 200 ticks; X starts the trot, and half the scenarios
     press B, Rb, Rb (BODY_DOWN) from different ticks: SIT_DOWN entered on
     exactly those scenarios and ticks, fused_admm once per tick that
     solves;
 19. fixture: the windows of tests/data/runner_a1.npz (boot, switch, trot)
     resumed from the JAX checkpoints at the CPU test's limits (FSM states
     and contact flags equal).
Every phase line ends with its wall time since the previous line. The last
two lines are a JSON object describing the kernels (with each
kernel's bound: the larger of the bytes it must move over the memory rate
and its operations over the peak rate of their type) and the device JSON
object. There is no CPU path: without a CUDA device the script fails
before printing a result.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "rollout_cadenced_a1_h10.npz"
MODES_FIXTURE = ROOT / "tests" / "data" / "rollout_modes_a1.npz"
WBC_FIXTURE = ROOT / "tests" / "data" / "rollout_wbc_a1.npz"
WB_FIXTURE = ROOT / "tests" / "data" / "whole_body_a1.npz"
WALK_FIXTURE = ROOT / "tests" / "data" / "walk_a1.npz"
TRANS_FIXTURE = ROOT / "tests" / "data" / "gait_transition_a1.npz"
BATCH = 2048
N_PERIODS = 18
# Kernel vs plain: max |diff| <= ATOL + RTOL |plain| on the scaled iterates.
# The two differ only in the mat-vec summation order (four FMA chains in
# the kernel, cuBLAS's order in the plain version).
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 1e-4
# Card vs the JAX fixture (same numbers as tests/test_torch_rollout.py:
# about 10x the port-vs-JAX differences measured on CPU).
FIXTURE_TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
               "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
               "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-5}
MG = 13.0 * 9.81
# fused_full_solve vs plain: on the card both run the bf16 steps as bf16
# tensor-core products with float32 accumulation (the plain version through
# torch.bmm), which agree bit for bit where the two sum in the same order;
# the 3-pass polish sums its three products in one accumulator in the kernel
# and in three in the plain version, and the ADMM loop sums in other orders.
# Unscaled forces within 0.5 N (0.4% m*g); the inverse's residual
# max|I - MX| below 5e-3 for both (one polish step leaves ~1e-3 on the
# hardest of 2048 problems) and within 1e-4 of each other.
FULL_FORCE_ATOL, FULL_RESIDUAL, FULL_RESIDUAL_GAP = 0.5, 5e-3, 1e-4
# unrolled_dots vs plain: (max, mean) |diff| after 10 chained products;
# after normalisation the entries are <= 1. The kernel is held within them
# against the plain version (exact products, IEEE float32 sums) and against
# the chain summed in float64; a control must fail them, or they have no
# teeth. bf16: summing the same exact products in another order moves a
# sum near a rounding tie one bf16 step (2^-8) and it carries, so the max
# alone cannot tell a sound kernel (0.0117 from plain) from one whose store
# truncates (the control, `mxu_rate.truncated_chain`: max 0.0117 at B=16 on
# the CPU); the mean can (CPU B=16: plain vs float64 2.3e-5, the control
# 1.2e-3). float32: the three TF32 passes against exact float32, the
# control one TF32 pass (~1e-3 away); against its own arithmetic in torch
# ops (`tf32_chain`) the tensor cores' summation order is the only
# difference (measured 3.5e-6).
DOTS_TOL = {"bf16": (2e-2, 2e-4), "f32": (1e-5, 1e-6)}
DOTS_3PASS_ATOL = 5e-6
BENCH_BATCH = 8192
# The force-balance rollouts (phase 8): ticks of 2 ms (the TROT cycle is
# 0.5 s, 250 ticks; cut to 100 to keep the script inside its time).
MODE_TICKS = {"velocity": 100, "position": 100}
PROFILE_TICKS = 1
# Card vs the JAX modes fixture (phase 9), as tests/test_torch_locomotion_
# modes.py: the cadenced fixture's limits, touchdown anchors 1e-3 m (the
# velocity-mode foothold follows the base velocity over half a stance).
MODES_FIXTURE_TOL = dict(FIXTURE_TOL, foot_anchor=1e-3)
# The WBC and whole-body paths (phases 10-12): B, ticks, and the ticks
# profiled (one MPC cadence cycle of 8 ticks: 1 solve, 3 WBC ticks).
WB_BATCH = 1024
WBC_TICKS = 400
WB_TICKS = 300
CYCLE_TICKS = 8
CROSS_BATCH, CROSS_TICKS = 64, 600
# Card vs the JAX fixtures, the limits of tests/test_torch_wbc.py and
# tests/test_torch_whole_body.py (each with the CPU reading there).
WBC_FIXTURE_TOL = dict(FIXTURE_TOL, foot_anchor=1e-4,
                       forces_trace=0.01 * 13.0 * 9.81, tau_trace=0.3)
WBC_TICK_TOL = {"q_des": 1e-4, "dq_des": 5e-4, "tau": 2e-3}
WB_FIXTURE_TOL = {"quat": 4e-3, "position": 2e-3, "omega_body": 0.1,
                  "vel_body": 3e-2, "q": 4e-2, "height_trace": 5e-4,
                  "vx_trace": 2e-2}
# The walk (phase 13): B, ticks (past the first TRUE_SWING entry at tick
# 308 of the 3.7 s table; the JAX bench times 500).
WALK_BATCH, WALK_TICKS = 256, 320
# The walk windows of the fixture (phase 15): the first 60 of each
# window's 120 ticks (every event is at tick 10), at the CPU test's limits.
WALK_WINDOW_TICKS = 60
# Gait transitions (phase 14): B, the JAX test's segments and, per pattern,
# the gait_switch level of each segment; rows 0-3 are the fixture's
# scenarios (tests/test_torch_gait_transition.py: vx 0.25, rows 0-1 switch
# in segment 2).
TRANS_BATCH = 64
TRANS_PATTERNS = ((0, 1, 0, 1, 0), (0, 1, 0, 0, 0), (0, 0, 0, 1, 0),
                  (0, 0, 0, 0, 0), (1, 0, 0, 1, 0))
# The robot runner (phases 16-19): B, ticks from the sitting boot, ramp
# ticks without the shortcut, ticks from the pre-switch checkpoint (the
# switch on its 100th tick), and the RC loop's B and ticks.
RUNNER_BATCH = 1024
RUNNER_BOOT_TICKS, RUNNER_MIRROR_TICKS = 200, 20
RUNNER_SWITCH_TICKS = 250
RC_BATCH, RC_TICKS = 2048, 200
# Peaks of one H100 SXM (NVIDIA data sheet, dense): device memory bytes/s
# and operations/s by type (bf16 and TF32 on the tensor cores, float32 off
# them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over the memory rate and the sum of operations over
    the peak rate of their type."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = sum(count / PEAK_OPS_PER_S[kind] for kind, count in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def admm_work(batch: int, n: int, iters: int) -> tuple[float, dict]:
    """(bytes, ops) of one ADMM kernel launch on B problems of n variables:
    the n x n matrix, q, mu, lo, hi, rho, x0, y0 read once, x and y written
    once (float32); per iteration the mat-vec (2 n^2), A x and A^T w (4 m)
    and the z, y and x updates (12 m + 4 n)."""
    m = 5 * n // 3
    floats = n * n + 3 * n + 1 + 5 * m
    ops = iters * (2 * n * n + 16 * m + 4 * n)
    return 4.0 * batch * floats, {"f32": float(batch * ops)}


def newton_schulz_ops(batch: int, n: int, ns_bf16: int, ns_f32: int) -> dict:
    """bf16 tensor-core operations of the inverse: two n x n products a
    step, one pass each in the bf16 steps and three in the 3-pass polish."""
    return {"bf16": float(batch * (2 * ns_bf16 + 6 * ns_f32) * 2 * n ** 3)}


def device_profile(fn, ticks: int, tick_ms: float) -> dict:
    """CUDA kernels per tick and the device's busy share: fn() runs `ticks`
    control ticks under torch.profiler (device activity only: the host
    operators' events would cost tens of seconds to collect over ~20k
    kernels a tick); busy share = the union of the kernels' device
    intervals per tick over `tick_ms`, the host time of a tick measured
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return dict(kernels_per_tick="not measured",
                    device_busy_share="not measured")
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return dict(kernels_per_tick=len(spans) / ticks,
                device_us_per_tick=busy_us / ticks,
                device_busy_share=busy_us / ticks / (1e3 * tick_ms))


_LAST_LINE = [time.perf_counter()]


def phase(name: str, **values):
    now = time.perf_counter()
    values["phase_wall_s"] = f"{now - _LAST_LINE[0]:.1f}"
    _LAST_LINE[0] = now
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "runs only on the card")
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                           TwistCommand)
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.control.stance_force_balance import \
        ForceBalanceConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT, TROT
    from quadruped_tpu_torch.sim import rollout as rollout_mod
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced
    from quadruped_tpu_torch import bench
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.solvers import (cone_qp, fused_admm,
                                             fused_full_solve)
    from quadruped_tpu_torch.solvers import problems
    from quadruped_tpu_torch.solvers.problems import bench_problems
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.benchmarks import transition as bench_trans
    from quadruped_tpu_torch.benchmarks import runner as bench_runner
    from quadruped_tpu_torch.gait.walk import SubLegState
    from quadruped_tpu_torch.planner import pose_planner
    from quadruped_tpu_torch.control import wbc as wbc_mod
    from quadruped_tpu_torch.utils import card, cuda_build

    wrappers = {"fused_admm": fused_admm.fused_admm,
                "fused_full_solve": fused_full_solve.fused_full_solve,
                "unrolled_dots": mxu_rate.unrolled_dots}

    def reset_counts():
        for wrapper in wrappers.values():
            wrapper.launches = 0

    def counts_after(path: str, kernel: str, expected=None) -> int:
        """The launch counts of the run of `path` since reset_counts(): only
        `kernel` launched, `expected` times (at least once if None)."""
        counts = {name: w.launches for name, w in wrappers.items()}
        n = counts[kernel]
        others = sum(counts.values()) - n
        if others or n == 0 or (expected is not None and n != expected):
            raise RuntimeError(f"{path}: kernel launches {counts}, expected "
                               f"{expected or 'some'} of {kernel} only")
        return n

    def admm_vs_plain(where: str, args, kw) -> tuple[float, float]:
        """fused_admm against its plain version on the same operands, held
        to KERNEL_ATOL / KERNEL_RTOL; returns (max |dx|, max |dy|)."""
        xk, yk = fused_admm.fused_admm(*args, **kw)
        xr, yr = fused_admm.fused_admm_reference(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
            raise RuntimeError(f"fused_admm output not finite ({where})")
        torch.testing.assert_close(xk, xr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        torch.testing.assert_close(yk, yr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        return (xk - xr).abs().max().item(), (yk - yr).abs().max().item()

    def full_vs_plain(where: str, ops, d, kw) -> dict:
        """fused_full_solve against its plain version on the same operands,
        held to the FULL_* limits (forces unscaled by d); returns the
        compared numbers by name."""
        xk, yk, ik = fused_full_solve.fused_full_solve(
            *ops, **kw, return_inverse=True)
        xr, yr, ir = fused_full_solve.fused_full_solve_reference(*ops, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
            raise RuntimeError(f"fused_full_solve output not finite ({where})")
        eye = torch.eye(ops[0].shape[-1], device=dev)
        res_k, res_p = ((eye - torch.bmm(ops[0], inv)).abs().max().item()
                        for inv in (ik, ir))
        dforce = (xk * d - xr * d).abs().max().item()
        if not (res_k < FULL_RESIDUAL and res_p < FULL_RESIDUAL
                and abs(res_k - res_p) <= FULL_RESIDUAL_GAP
                and dforce <= FULL_FORCE_ATOL):
            raise RuntimeError(
                f"fused_full_solve vs plain ({where}): residuals "
                f"{res_k:.3g} / {res_p:.3g}, forces {dforce}")
        # The bf16 steps alone (no polish): the kernel's tensor-core
        # products against the plain version's, expected equal bit for bit.
        steps = dict(kw, ns_iters=kw["ns_iters"] - kw["ns_f32_polish"],
                     ns_f32_polish=0, iters=0)
        _, _, ib = fused_full_solve.fused_full_solve(*ops, **steps,
                                                     return_inverse=True)
        ib_plain = fused_full_solve.newton_schulz_reference(
            ops[0], steps["ns_iters"], 0)
        return dict(max_abs_dforce_N=dforce,
                    bf16_steps_max_abs_dX=(ib - ib_plain).abs().max().item(),
                    max_abs_dx_scaled=(xk - xr).abs().max().item(),
                    max_abs_dy=(yk - yr).abs().max().item(),
                    residual_kernel=res_k, residual_plain=res_p)

    def full_rates(ops, kw, ms: float) -> dict:
        """K2's inverse stage alone (a launch with iters=0): its time and
        achieved TFLOP/s, and the launch with no Newton-Schulz step (load of
        M, X_0, the loop's set-up) and with the bf16 steps only; the whole
        kernel's bound and share of it."""
        batch, n = ops[1].shape

        def stage_ms(**over) -> float:
            return card.time_ms(lambda: fused_full_solve.fused_full_solve(
                *ops, **dict(kw, iters=0, **over)), 10)

        inv_ms = stage_ms()
        load_ms = stage_ms(ns_iters=0, ns_f32_polish=0)
        bf16_ms = stage_ms(ns_iters=kw["ns_iters"] - kw["ns_f32_polish"],
                           ns_f32_polish=0)
        ns = newton_schulz_ops(batch, n, kw["ns_iters"] - kw["ns_f32_polish"],
                               kw["ns_f32_polish"])
        nbytes, ops_admm = admm_work(batch, n, kw["iters"])
        b_ms, b_by = bound(nbytes, dict(ns, **ops_admm))
        return dict(inverse_ms=inv_ms, load_only_ms=load_ms,
                    bf16_steps_ms=bf16_ms,
                    inverse_tflops=ns["bf16"] / inv_ms / 1e9,
                    bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms)

    def hold(name: str, got: dict, want: dict, tol: dict, **extra):
        """max |got - want| per key of `tol`, printed beside its limit on
        the line `name`; raises if any is over its limit."""
        errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in tol}
        phase(name, **extra,
              **{k: f"{e:.3g}/{tol[k]:g}" for k, e in errs.items()})
        bad = {k: e for k, e in errs.items() if not e <= tol[k]}
        if bad:
            raise RuntimeError(f"{name} mismatch: {bad}")

    full_tol = (f"forces {FULL_FORCE_ATOL} N, residual < {FULL_RESIDUAL}, "
                f"gap <= {FULL_RESIDUAL_GAP}")
    admm_tol = f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}"

    # 0. Environment.
    smi = card.name_and_power_limit()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase("env", card=json.dumps(smi), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          tf32=torch.backends.cuda.matmul.allow_tf32)

    # 1. Build, one nvcc per source, all at once.
    t0 = time.perf_counter()
    sources = {"fused_admm": fused_admm.SOURCE,
               "fused_full_solve": fused_full_solve.SOURCE,
               "unrolled_dots": mxu_rate.SOURCE}
    built = cuda_build.build_shared_libraries(
        [(src, name) for name, src in sources.items()])
    seconds = time.perf_counter() - t0
    # Dynamic shared memory a block takes (K3: bf16 / float32, as its
    # library gives them).
    dyn_smem = {"fused_admm": 4 * fused_admm.VECTOR_FLOATS,
                "fused_full_solve": fused_full_solve.SMEM_BYTES,
                "unrolled_dots": "/".join(
                    str(mxu_rate.smem_bytes(t)) for t in mxu_rate.DTYPES)}
    for name, (_, log) in zip(sources, built):
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "C7511" in ln]
        phase(f"build:{name}", seconds=f"{seconds:.3f}",
              dynamic_smem_bytes=dyn_smem[name],
              ptxas=json.dumps(" | ".join(ptxas)))

    # 2. Kernel vs plain on B=2048 production-shaped problems.
    params = a1_params(dev)
    prob, table = bench_problems(BATCH, horizon=10, device=dev)
    cold = cone_qp.admm_inputs(
        prob, x0=mpc_mod.gravity_warm_start(params, table),
        y0=torch.zeros(BATCH, 40, 5, device=dev))
    x_boot, y_boot = fused_admm.fused_admm(
        *cold[:8], iters=400, sigma=cone_qp.SIGMA, alpha=1.6)
    warm = cold._replace(x0=x_boot, y0=y_boot)
    cases = {"cold": (cold, dict(iters=400, alpha=1.6, accel_restart=0)),
             "warm": (warm, dict(iters=24, alpha=1.0, accel_restart=20))}
    timing, max_err = {}, 0.0
    for name, (inp, kw) in cases.items():
        kw = dict(kw, sigma=cone_qp.SIGMA)
        args = inp[:8]
        dx, dy = admm_vs_plain(name, args, kw)
        max_err = max(max_err, dx, dy)
        ms = card.time_ms(lambda: fused_admm.fused_admm(*args, **kw), 20)
        plain_ms = card.time_ms(
            lambda: fused_admm.fused_admm_reference(*args, **kw), 3)
        nbytes, ops = admm_work(BATCH, args[1].shape[1], kw["iters"])
        b_ms, b_by = bound(nbytes, ops)
        timing[name] = (ms, plain_ms, b_ms, b_by)
        phase(f"kernel_vs_plain:{name}", batch=BATCH, n=args[1].shape[1],
              iters=kw["iters"], max_abs_dx=dx, max_abs_dy=dy,
              tol=admm_tol, kernel_ms=ms, plain_ms=plain_ms,
              achieved_GBps=nbytes / ms / 1e6, bound_ms=b_ms, bound_by=b_by,
              share_of_bound=b_ms / ms)

    # The boot solve at unblocked H=16 (n = 192), held on its unscaled
    # first-step forces (the scaled iterates part past the limits above
    # over 400 relaxed iterations at this size).
    prob, x0, boot_cfg = problems.boot_problems(BATCH, horizon=16,
                                                device=dev)
    inp = cone_qp.admm_inputs(prob, x0=x0,
                              y0=torch.zeros(BATCH, 64, 5, device=dev))
    args = inp[:8]
    kw = dict(iters=boot_cfg.qp_cold_iters, sigma=cone_qp.SIGMA,
              alpha=boot_cfg.qp_cold_alpha, accel_restart=0)
    xk, yk = fused_admm.fused_admm(*args, **kw)
    xr, _ = fused_admm.fused_admm_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
        raise RuntimeError("fused_admm output not finite (boot, n = 192)")
    dforce = ((xk - xr) * inp.d)[:, :12].abs().max().item()
    ms = card.time_ms(lambda: fused_admm.fused_admm(*args, **kw), 10)
    plain_ms = card.time_ms(
        lambda: fused_admm.fused_admm_reference(*args, **kw), 3)
    nbytes, ops = admm_work(BATCH, args[1].shape[1], kw["iters"])
    b_ms, b_by = bound(nbytes, ops)
    timing["boot_n192"] = (ms, plain_ms, b_ms, b_by, dforce)
    phase("kernel_vs_plain:boot_n192", batch=BATCH, n=args[1].shape[1],
          iters=kw["iters"], max_abs_dforce_N=dforce,
          max_abs_dforce_mg=dforce / MG, tol="0.01 m*g", kernel_ms=ms,
          plain_ms=plain_ms, achieved_GBps=nbytes / ms / 1e6, bound_ms=b_ms,
          bound_by=b_by, share_of_bound=b_ms / ms)
    if not dforce <= 0.01 * MG:
        raise RuntimeError(f"fused_admm vs plain (boot, n = 192): first-step "
                           f"forces differ by {dforce} N > 1% m*g")

    # 3. The slice: rollout_cadenced at B=2048 through the kernel.
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(dev))
    rng = np.random.default_rng(0)
    vx = (0.2 + 0.6 * rng.random(BATCH)).astype(np.float32)
    wz = (rng.normal(size=BATCH) * 0.2).astype(np.float32)
    cmd = TwistCommand.constant(vx=vx, wz=wz, device=dev)
    rollout_cadenced(config, params, cmd, 1)      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = rollout_cadenced(config, params, cmd, N_PERIODS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # One launch per solve: 1 boot + N_PERIODS periods.
    launches_slice = counts_after("rollout_cadenced", "fused_admm",
                                  1 + N_PERIODS)
    tensors = [getattr(res.sim, f.name) for f in
               res.sim.__dataclass_fields__.values()]
    tensors += [res.base_height_trace, res.vel_trace]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError("non-finite state in the rollout")
    alive = res.alive.mean().item()
    h = res.sim.position[:, 2]
    ticks = BATCH * N_PERIODS * config.mpc.ticks_per_solve
    phase("slice", batch=BATCH, periods=N_PERIODS,
          kernel_launches=launches_slice,
          alive_fraction=alive, final_height_min=h.min().item(),
          final_height_max=h.max().item(), final_height_std=h.std().item(),
          mean_vx_last=res.vel_trace[:, -1, 0].mean().item(),
          wall_s=wall, ticks_per_s=ticks / wall)
    if alive < 0.99:
        raise RuntimeError(f"alive fraction {alive} < 0.99")

    # 4. The JAX fixture, on the card.
    want = dict(np.load(FIXTURE))
    fres = rollout_cadenced(config, params, TwistCommand.constant(
        vx=want["vx"], device=dev), int(want["base_height_trace"].shape[1]))
    got = {k: getattr(fres.sim, k).cpu().numpy() for k in FIXTURE_TOL
           if hasattr(fres.sim, k)}
    got["base_height_trace"] = fres.base_height_trace.cpu().numpy()
    got["vel_trace"] = fres.vel_trace.cpu().numpy()
    if not np.array_equal(fres.alive.cpu().numpy(), want["alive"]):
        raise RuntimeError("fixture: alive mask differs")
    hold("fixture", got, want, FIXTURE_TOL)

    # 5. fused_full_solve vs plain at B=2048, n=120.
    full_timing, full_err = {}, 0.0
    for horizon in (10, 16):
        _, args, cfg = bench.build_bench(BATCH, "loop", horizon, device=dev)
        prob = bench.cadence_problem(cfg, params, *args[:4])
        for name, warm, kw in [
                ("cold", (None, None),
                 dict(iters=400, alpha=1.6, accel_restart=0)),
                ("warm", args[4:6],
                 dict(iters=24, alpha=1.0, accel_restart=20))]:
            m_mat, inp = cone_qp.admm_operands(prob, cone_qp.RHO_CONE,
                                               cone_qp.SIGMA, *warm)
            ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0,
                   inp.y0)
            kw = dict(kw, sigma=cone_qp.SIGMA, ns_iters=cone_qp.NS_ITERS,
                      ns_f32_polish=1)
            held = full_vs_plain(f"H={horizon}, {name}", ops, inp.d, kw)
            full_err = max(full_err, held["max_abs_dforce_N"])
            ms = card.time_ms(
                lambda: fused_full_solve.fused_full_solve(*ops, **kw), 10)
            plain_ms = card.time_ms(
                lambda: fused_full_solve.fused_full_solve_reference(*ops,
                                                                    **kw), 3)
            rates = full_rates(ops, kw, ms)
            if horizon == 10 and name == "warm":
                rates["library_ms"] = card.time_ms(
                    lambda: torch.linalg.inv(m_mat), 10)
            full_timing[(horizon, name)] = (ms, plain_ms, rates)
            phase(f"full_vs_plain:h{horizon}:{name}", batch=BATCH,
                  n=m_mat.shape[-1], move_block=cfg.move_block,
                  iters=kw["iters"], **held, tol=full_tol, kernel_ms=ms,
                  plain_ms=plain_ms, **rates)

    # 6. unrolled_dots vs plain (with the readings that set its limits),
    # its load and store alone, then the benchmark through the kernel.
    dots_acc = mxu_rate.accuracy(1024, 10, dev)
    dots_held = {}
    for tag, acc in dots_acc.items():
        limits = DOTS_TOL[tag]
        for key in ("kernel_vs_plain", "kernel_vs_f64"):
            err, mean = acc[key]
            if not (err <= limits[0] and mean <= limits[1]):
                raise RuntimeError(f"unrolled_dots {key} ({tag}): max {err}, "
                                   f"mean {mean}; limits {limits}")
        control = acc["control_vs_plain"]
        if control[0] <= limits[0] and control[1] <= limits[1]:
            raise RuntimeError(f"unrolled_dots ({tag}): the control "
                               f"{control} passes the limits {limits}")
        if tag == "f32" and not acc["kernel_vs_3pass"][0] <= DOTS_3PASS_ATOL:
            raise RuntimeError(f"unrolled_dots vs tf32_chain: "
                               f"{acc['kernel_vs_3pass'][0]} > "
                               f"{DOTS_3PASS_ATOL}")
        m = mxu_rate.problems(1024, mxu_rate.DTYPES[tag], dev)
        dots_held[tag] = dict(
            {k: "/".join(map(str, v)) for k, v in acc.items()},
            tol="/".join(map(str, limits)),
            kernel_ms_load_only=card.time_ms(
                lambda: mxu_rate.unrolled_dots(m, 0), 10))
        if tag == "f32":
            dots_held[tag]["tol_3pass"] = DOTS_3PASS_ATOL
    reset_counts()
    rate = mxu_rate.measure(1024, 10, reps=10, device=dev)
    dots_launches = counts_after("mxu_rate.measure", "unrolled_dots")
    for tag, versions in rate.items():
        phase(f"dots:{tag}", batch=1024, iters=10, **dots_held[tag],
              launches=dots_launches,
              **{f"{name}_{key}": value for name, (ms, tf) in versions.items()
                 for key, value in (("ms", ms), ("tflops", tf))},
              card=json.dumps(smi))

    # 7. The MPC-update benchmark: one counted update per route, its kernel
    # against the plain version on that update's operands, then its rate.
    bench_launches = {"fused_admm": 0, "fused_full_solve": 0}
    bench_timing = {}
    for horizon in (10, 16):
        first_step = {}
        for solver in bench.SOLVERS:
            fn, args, cfg = bench.build_bench(BENCH_BATCH, solver, horizon,
                                              device=dev)
            torch.cuda.synchronize()
            kernel = "fused_admm" if solver == "loop" else "fused_full_solve"
            where = f"bench H={horizon} {solver}"
            reset_counts()
            x, y = fn(*args)
            torch.cuda.synchronize()
            launches = counts_after(where, kernel, 1)
            bench_launches[kernel] += launches
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise RuntimeError(f"{where}: not finite")
            first_step[solver] = x[:, :12]
            # The operands the route's solve hands its kernel.
            prob = bench.cadence_problem(cfg, params, *args[:4])
            kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                      accel_restart=cfg.qp_accel_restart, sigma=cone_qp.SIGMA)
            if solver == "loop":
                ops = cone_qp.admm_inputs(prob, x0=args[4], y0=args[5])[:8]
                dx, dy = admm_vs_plain(where, ops, kw)
                max_err = max(max_err, dx, dy)
                held = dict(max_abs_dx=dx, max_abs_dy=dy, tol=admm_tol)
                run = fused_admm.fused_admm
                run_plain = fused_admm.fused_admm_reference
            else:
                m_mat, inp = cone_qp.admm_operands(
                    prob, cone_qp.RHO_CONE, cone_qp.SIGMA, *args[4:6])
                ops = (m_mat, inp.q, inp.mu, inp.lo, inp.hi, inp.rho, inp.x0,
                       inp.y0)
                kw = dict(kw, ns_iters=cone_qp.NS_ITERS, ns_f32_polish=1)
                held = dict(full_vs_plain(where, ops, inp.d, kw),
                            tol=full_tol)
                full_err = max(full_err, held["max_abs_dforce_N"])
                run = fused_full_solve.fused_full_solve
                run_plain = fused_full_solve.fused_full_solve_reference
            ms = card.time_ms(lambda: run(*ops, **kw), 10)
            plain_ms = card.time_ms(lambda: run_plain(*ops, **kw), 3)
            if solver == "loop":
                nbytes, ops_admm = admm_work(BENCH_BATCH, x.shape[1],
                                             kw["iters"])
                b_ms, b_by = bound(nbytes, ops_admm)
                measured = dict(achieved_GBps=nbytes / ms / 1e6,
                                bound_ms=b_ms, bound_by=b_by,
                                share_of_bound=b_ms / ms)
            else:
                measured = full_rates(ops, kw, ms)
                # A yardstick for the inverse stage, never called by the
                # port: the library's batched inverse of the same M.
                measured["linalg_inv_ms"] = card.time_ms(
                    lambda: torch.linalg.inv(ops[0]), 10)
            bench_timing[(horizon, kernel)] = (ms, plain_ms, measured)
            rates = bench.update_rates(fn, args, BENCH_BATCH, reps=10,
                                       runs=3)
            phase(f"bench:h{horizon}:{solver}", batch=BENCH_BATCH,
                  n=x.shape[1], move_block=cfg.move_block,
                  kernel_launches=launches, **held, kernel_ms=ms,
                  plain_ms=plain_ms, **measured,
                  solves_per_s=rates[len(rates) // 2],
                  band=f"{rates[0]:.1f}-{rates[-1]:.1f}",
                  card=json.dumps(smi))
        dforce = (first_step["loop"] - first_step["full"]).abs().max().item()
        phase(f"bench:h{horizon}:routes", max_first_step_dforce_mg=dforce / MG,
              tol=0.03)
        if not dforce <= 0.03 * MG:
            raise RuntimeError(f"bench H={horizon}: routes differ by "
                               f"{dforce / MG:.4f} m*g")

    # 8. The force-balance modes at B=2048: no kernel of the port launches.
    def mode_config(mode):
        return LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                                swing=swing_mod.SwingConfig(mode=mode),
                                gait=TROT(dev), mode=mode,
                                force_balance=ForceBalanceConfig())

    rng = np.random.default_rng(0)
    mode_cmds = {
        "velocity": (ControlMode.VELOCITY,
                     (0.1 + 0.3 * rng.random(BATCH)).astype(np.float32)),
        "position": (ControlMode.POSITION,
                     (0.1 * rng.random(BATCH)).astype(np.float32))}
    for name, (mode, vx) in mode_cmds.items():
        config = mode_config(mode)
        cmd = TwistCommand.constant(vx=vx, body_height=0.27, device=dev)
        rollout_mod.rollout(config, params, cmd, 2)     # warm-up
        torch.cuda.synchronize()
        ticks = MODE_TICKS[name]
        reset_counts()
        t0 = time.perf_counter()
        res = rollout_mod.rollout(config, params, cmd, ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        if any(counts.values()):
            raise RuntimeError(f"{name} mode launched kernels: {counts}")
        tensors = [getattr(res.sim, f) for f in res.sim.__dataclass_fields__]
        tensors += [res.base_height_trace, res.vel_trace, res.forces_trace]
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            raise RuntimeError(f"non-finite state in the {name} rollout")
        alive = res.alive.mean().item()
        tick_ms = 1e3 * wall / ticks
        carry = rollout_mod.RolloutCarry(sim=res.sim, ctrl=res.control,
                                         dead=1.0 - res.alive, step=ticks)
        prof = device_profile(lambda: rollout_mod.rollout_segment(
            config, params, cmd, carry, PROFILE_TICKS), PROFILE_TICKS,
            tick_ms)
        h = res.sim.position[:, 2]
        phase(f"{name}:B{BATCH}", ticks=ticks, sim_s=ticks * 0.002,
              kernel_launches=json.dumps(counts), alive_fraction=alive,
              final_height_min=h.min().item(),
              final_height_max=h.max().item(),
              mean_vx_last=res.vel_trace[:, -50:, 0].mean().item(),
              wall_s=wall, ms_per_tick=tick_ms,
              ticks_per_s=BATCH * ticks / wall, **prof, card=json.dumps(smi))
        if alive < 0.99:
            raise RuntimeError(f"{name}: alive fraction {alive} < 0.99")

    # 9. The JAX modes fixture, on the card.
    data = np.load(MODES_FIXTURE)
    for name, (mode, _) in mode_cmds.items():
        want = {k[len(name) + 1:]: data[k] for k in data.files
                if k.startswith(name + "_")}
        ticks, step = int(want["ticks"]), int(data["trace_stride"])
        fres = rollout_mod.rollout(mode_config(mode), params,
                                   TwistCommand.constant(
                                       vx=want["vx"], body_height=0.27,
                                       device=dev), ticks)
        got = {k: getattr(fres.sim, k).cpu().numpy() for k in FIXTURE_TOL
               if hasattr(fres.sim, k)}
        got["base_height_trace"] = \
            fres.base_height_trace[:, step - 1::step].cpu().numpy()
        got["vel_trace"] = fres.vel_trace[:, step - 1::step].cpu().numpy()
        if not np.array_equal(fres.alive.cpu().numpy(), want["alive"]):
            raise RuntimeError(f"fixture {name}: alive mask differs")
        hold(f"fixture:{name}", got, want, MODES_FIXTURE_TOL, ticks=ticks)

    # 10. The WBC: one batched tick on the benchmark states, then the
    # use_wbc closed loop.
    step, wbc_args = bench_wbc.build(WB_BATCH, dev)
    step(*wbc_args)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(10):
        step(*wbc_args)
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / 10
    counts = {k: w.launches for k, w in wrappers.items()}
    if any(counts.values()):
        raise RuntimeError(f"wbc_step launched kernels: {counts}")
    prof = device_profile(lambda: [step(*wbc_args) for _ in range(3)], 3,
                          tick_ms)
    if not all(bool(torch.isfinite(o).all()) for o in step(*wbc_args)):
        raise RuntimeError("wbc_step: not finite")
    phase(f"wbc_tick:B{WB_BATCH}", ms_per_tick=tick_ms,
          ticks_per_s=WB_BATCH / tick_ms * 1e3,
          kernel_launches=json.dumps(counts), **prof, card=json.dumps(smi))

    wbc_calls = [0]
    wbc_step = wbc_mod.wbc_step

    def counted_wbc(*a, **k):
        wbc_calls[0] += 1
        return wbc_step(*a, **k)

    wbc_config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                                  swing=swing_mod.SwingConfig(),
                                  gait=ADVANCED_TROT(dev),
                                  wbc=wbc_mod.WbcConfig(), use_wbc=True)
    rng = np.random.default_rng(0)
    cmd = TwistCommand.constant(
        vx=(0.2 + 0.4 * rng.random(WB_BATCH)).astype(np.float32),
        body_height=0.27, device=dev)
    rollout_mod.rollout(wbc_config, params, cmd, 4)     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    wbc_mod.wbc_step = counted_wbc
    try:
        t0 = time.perf_counter()
        res = rollout_mod.rollout(wbc_config, params, cmd, WBC_TICKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        wbc_mod.wbc_step = wbc_step
    solves = -(-WBC_TICKS // CYCLE_TICKS)
    launches_wbc = counts_after("wbc_rollout", "fused_admm", 1 + solves)
    expected_wbc = sum(1 for i in range(WBC_TICKS)
                       if i % 2 == 0 and i % CYCLE_TICKS)
    if wbc_calls[0] != expected_wbc:
        raise RuntimeError(f"wbc_rollout: the WBC ran {wbc_calls[0]} times, "
                           f"expected {expected_wbc}")
    tensors = [getattr(res.sim, f) for f in res.sim.__dataclass_fields__]
    tensors += [res.base_height_trace, res.vel_trace, res.forces_trace,
                res.tau_trace]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError("non-finite state in the use_wbc rollout")
    alive = res.alive.mean().item()
    tick_ms = 1e3 * wall / WBC_TICKS
    carry = rollout_mod.RolloutCarry(sim=res.sim, ctrl=res.control,
                                     dead=1.0 - res.alive, step=WBC_TICKS)
    prof = device_profile(lambda: rollout_mod.rollout_segment(
        wbc_config, params, cmd, carry, CYCLE_TICKS), CYCLE_TICKS, tick_ms)
    h = res.sim.position[:, 2]
    phase(f"wbc_rollout:B{WB_BATCH}", ticks=WBC_TICKS,
          kernel_launches=launches_wbc, wbc_calls=wbc_calls[0],
          alive_fraction=alive, final_height_min=h.min().item(),
          final_height_max=h.max().item(),
          mean_vx_last=res.vel_trace[:, -100:, 0].mean().item(),
          wall_s=wall, ms_per_tick=tick_ms,
          ticks_per_s=WB_BATCH * WBC_TICKS / wall, **prof,
          card=json.dumps(smi))
    if alive < 0.99:
        raise RuntimeError(f"wbc_rollout: alive fraction {alive} < 0.99")

    # 11. The whole-body closed loop, then the cross-simulator check.
    bench_wb.run(bench_wb.build(WB_BATCH, dev), 2)       # warm-up
    torch.cuda.synchronize()
    reset_counts()
    loop = bench_wb.build(WB_BATCH, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop, _ = bench_wb.run(loop, WB_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_wb = counts_after("whole_body", "fused_admm",
                               1 + -(-WB_TICKS // CYCLE_TICKS))
    s = loop.sim.fb
    if not all(bool(torch.isfinite(getattr(s, f)).all())
               for f in s.__dataclass_fields__):
        raise RuntimeError("non-finite state in the whole-body loop")
    alive_mask = bench_wb.alive(loop) > 0.5
    alive = alive_mask.float().mean().item()
    h = s.position[alive_mask, 2]
    tick_ms = 1e3 * wall / WB_TICKS
    wb_rate = WB_BATCH * WB_TICKS / wall
    prof = device_profile(lambda: bench_wb.run(loop, CYCLE_TICKS),
                          CYCLE_TICKS, tick_ms)
    phase(f"whole_body:B{WB_BATCH}", ticks=WB_TICKS,
          kernel_launches=launches_wb, alive_fraction=alive,
          final_height_min=h.min().item(), final_height_max=h.max().item(),
          wall_s=wall, ms_per_tick=tick_ms, ticks_per_s=wb_rate,
          gazebo_equivalents=wb_rate / 500.0, **prof, card=json.dumps(smi))
    if alive < 0.99 or not (0.2 <= h.min().item()
                            and h.max().item() <= 0.35):
        raise RuntimeError(f"whole_body: alive {alive}, final heights "
                           f"{h.min().item()}-{h.max().item()}")

    cross_config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev))
    srb = rollout_mod.rollout(cross_config, params, TwistCommand.constant(
        vx=0.25, body_height=0.27, batch=CROSS_BATCH, device=dev),
        CROSS_TICKS)
    loop = bench_wb.build(CROSS_BATCH, dev, cross_config,
                          np.full(CROSS_BATCH, 0.25))
    _, (h_wb, vx_wb) = bench_wb.run(loop, CROSS_TICKS)
    win = slice(400, CROSS_TICKS)
    dh = (h_wb[:, win].mean(1)
          - srb.base_height_trace[:, win].mean(1)).abs().max().item()
    dvx = (vx_wb[:, win].mean(1)
           - srb.vel_trace[:, win, 0].mean(1)).abs().max().item()
    phase(f"whole_body:cross_srb:B{CROSS_BATCH}", ticks=CROSS_TICKS,
          srb_alive=srb.alive.mean().item(),
          mean_height_wb=h_wb[:, win].mean().item(),
          mean_height_srb=srb.base_height_trace[:, win].mean().item(),
          max_abs_dheight=dh, max_abs_dvx=dvx, tol="0.03 m / 0.15 m/s")
    if not (torch.isfinite(h_wb).all() and srb.alive.min().item() == 1.0
            and dh < 0.03 and dvx < 0.15):
        raise RuntimeError(f"cross-simulator check: height {dh}, vx {dvx}")

    # 12. The JAX fixtures of the WBC and the whole-body loop, on the card.
    data = dict(np.load(WBC_FIXTURE))
    fres = rollout_mod.rollout(LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=40),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev),
        wbc=wbc_mod.WbcConfig(), use_wbc=True), params,
        TwistCommand.constant(vx=data["vx"], body_height=0.27, device=dev),
        int(data["ticks"]))
    stride = int(data["trace_stride"])
    got = {k: getattr(fres.sim, k).cpu().numpy() for k in WBC_FIXTURE_TOL
           if hasattr(fres.sim, k)}
    for k in ("base_height_trace", "vel_trace"):
        got[k] = getattr(fres, k)[:, stride - 1::stride].cpu().numpy()
    got["forces_trace"] = fres.forces_trace.cpu().numpy()
    got["tau_trace"] = fres.tau_trace.cpu().numpy()
    if not np.array_equal(fres.alive.cpu().numpy(), data["alive"]):
        raise RuntimeError("fixture wbc_rollout: alive mask differs")
    hold("fixture:wbc_rollout", got, data, WBC_FIXTURE_TOL,
         ticks=int(data["ticks"]))

    step, wbc_args = bench_wbc.build(8, dev)
    outs = {k: o.cpu().numpy() for k, o in
            zip(("q_des", "dq_des", "tau"), step(*wbc_args))}
    hold("fixture:wbc_tick", outs,
         {k: data[f"wbc_tick_{k}"] for k in WBC_TICK_TOL}, WBC_TICK_TOL,
         batch=8)

    data = dict(np.load(WB_FIXTURE))
    loop = bench_wb.build(len(data["vx"]), dev, LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev)), data["vx"])
    loop, (h_wb, vx_wb) = bench_wb.run(loop, int(data["ticks"]))
    got = {k: getattr(loop.sim.fb, k).cpu().numpy() for k in WB_FIXTURE_TOL
           if hasattr(loop.sim.fb, k)}
    got["height_trace"] = h_wb.cpu().numpy()
    got["vx_trace"] = vx_wb.cpu().numpy()
    hold("fixture:whole_body", got, data, WB_FIXTURE_TOL,
         ticks=int(data["ticks"]))

    # 13. The statically-stable walk: the bench twin at B=256. The objects
    # the earlier phases left are moved out of the garbage collector's
    # reach first: the walk tick makes ~34k tensor objects, and full
    # collections over a large heap would be timed as tick time.
    gc.collect()
    gc.freeze()
    sqp_calls = [0]
    sqp = pose_planner.plan_target_pose_sqp

    def counted_sqp(*a, **k):
        sqp_calls[0] += 1
        return sqp(*a, **k)

    bench_walk.run(bench_walk.build(WALK_BATCH, dev), 2)     # warm-up
    torch.cuda.synchronize()
    loop = bench_walk.build(WALK_BATCH, dev)
    torch.cuda.synchronize()
    reset_counts()
    pose_planner.plan_target_pose_sqp = counted_sqp
    try:
        t0 = time.perf_counter()
        loop, tr = bench_walk.run(loop, WALK_TICKS, record=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pose_planner.plan_target_pose_sqp = sqp
    counts = {k: w.launches for k, w in wrappers.items()}
    if any(counts.values()):
        raise RuntimeError(f"walk launched kernels: {counts}")
    tensors = [getattr(loop.sim.fb, f) for f in loop.sim.fb.__dataclass_fields__]
    tensors += [t for t in (loop.walk.liftoff_pos_world,
                            loop.walk.foot_target_world,
                            loop.walk.warm_forces, loop.walk.pose.pose_target,
                            loop.walk.gait.normalized_phase,
                            tr["position"], tr["forces"], tr["q_cmd"])]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError("non-finite state in the walk")
    sub = tr["sub_state"].cpu().numpy()                      # [B, T, 4]
    swinging = sub == SubLegState.TRUE_SWING
    max_swinging = int(swinging.sum(-1).max())
    unload = sub == SubLegState.UNLOAD_FORCE
    left_unload = (unload[:, :-1] & ~unload[:, 1:]).any(1)   # [B, 4]
    legs_swung = int(swinging.any(1).sum())
    missed_swings = int((left_unload & ~swinging.any(1)).sum())
    # Replan ticks: a leg enters its swing window (or, on the first tick,
    # no plan is latched yet).
    prev = np.concatenate([np.ones_like(sub[:, :1]), sub[:, :-1]], 1)
    entering = ((sub == SubLegState.FULL_STANCE) & (prev == 1)).any((0, 2))
    entering[0] = True
    replan_ticks = int(entering.sum())
    alive = bench_walk.alive(loop).mean().item()
    tick_ms = 1e3 * wall / WALK_TICKS
    fresh = bench_walk.build(WALK_BATCH, dev)
    holder = [fresh]

    def one_tick():
        holder[0], _ = bench_walk.run(holder[0], 1)

    prof_replan = device_profile(one_tick, 1, tick_ms)
    prof_normal = device_profile(one_tick, 1, tick_ms)
    h = bench_walk.base_position(loop)[:, 2]
    phase(f"walk:B{WALK_BATCH}", ticks=WALK_TICKS, kernel_launches=
          json.dumps(counts), sqp_calls=sqp_calls[0],
          replan_ticks=replan_ticks, alive_fraction=alive,
          max_legs_in_true_swing=max_swinging, legs_swung=legs_swung,
          legs_that_left_unload_without_swinging=missed_swings,
          final_height_min=h.min().item(), final_height_max=h.max().item(),
          wall_s=wall, ms_per_tick=tick_ms,
          ticks_per_s=WALK_BATCH * WALK_TICKS / wall,
          robot_seconds_per_wall_second=WALK_BATCH * WALK_TICKS / wall
          * bench_walk.DT,
          **{f"replan_{k}": v for k, v in prof_replan.items()},
          **{f"normal_{k}": v for k, v in prof_normal.items()},
          card=json.dumps(smi))
    if (alive < 0.99 or max_swinging > 1 or missed_swings or legs_swung == 0
            or sqp_calls[0] != replan_ticks):
        raise RuntimeError(
            f"walk: alive {alive}, {max_swinging} legs in TRUE_SWING at "
            f"once, {missed_swings} legs left unload without swinging, "
            f"{legs_swung} swung, SQP {sqp_calls[0]} calls on "
            f"{replan_ticks} replan ticks")

    # 14. Gait transitions: trot -> walk -> trot at B=64.
    gc.collect()
    gc.freeze()
    trans_config = bench_trans.config(dev)
    pattern = np.asarray([TRANS_PATTERNS[i % len(TRANS_PATTERNS)]
                          for i in range(TRANS_BATCH)], np.float32)
    pattern[:4] = [TRANS_PATTERNS[0], TRANS_PATTERNS[0], TRANS_PATTERNS[3],
                   TRANS_PATTERNS[3]]
    rng = np.random.default_rng(0)
    trans_vx = (0.15 + 0.2 * rng.random(TRANS_BATCH)).astype(np.float32)
    trans_vx[:4] = 0.25
    carry = rollout_mod.rollout_init(trans_config, params, TRANS_BATCH)
    rollout_mod.rollout_segment(trans_config, params, TwistCommand.constant(
        vx=trans_vx, body_height=0.27, device=dev), carry, 2)    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    carry = rollout_mod.rollout_init(trans_config, params, TRANS_BATCH)
    t_phase, t_idx, seg_res = [], [], []
    t0 = time.perf_counter()
    for s, steps in enumerate(bench_trans.SEGMENTS):
        cmd = TwistCommand.constant(vx=trans_vx, body_height=0.27,
                                    gait_switch=pattern[:, s], device=dev)
        if s >= bench_trans.FIXTURE_SEGMENTS:
            # Past the fixture's segments the transition fields are not
            # needed tick by tick.
            carry, res = rollout_mod.rollout_segment(trans_config, params,
                                                     cmd, carry, steps)
            seg_res.append([res])
            continue
        res_ticks = []
        for _ in range(steps):
            carry, res = rollout_mod.rollout_segment(trans_config, params,
                                                     cmd, carry, 1)
            t_phase.append(carry.ctrl.transition.phase.clone())
            t_idx.append(carry.ctrl.transition.active_idx.clone())
            res_ticks.append(res)
        seg_res.append(res_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trans_ticks = sum(bench_trans.SEGMENTS)
    solves = -(-trans_ticks // CYCLE_TICKS)
    launches_trans = counts_after("gait_transition", "fused_admm",
                                  1 + solves)
    t_phase = torch.stack(t_phase, 1).cpu().numpy()
    t_idx = torch.stack(t_idx, 1).cpu().numpy()
    edges = ((pattern[:, 1:] > 0.5) & (pattern[:, :-1] <= 0.5)).sum(1) \
        + (pattern[:, 0] > 0.5)
    want_idx = (edges % 2).astype(np.float32)
    alive = (1.0 - carry.dead).mean().item()
    walk_end = sum(bench_trans.SEGMENTS[:3]) - 1
    on_walk = t_idx[:, walk_end] > 0.5
    fz = torch.stack([r.forces_trace[:, -1, :, 2]
                      for r in seg_res[2][-300:]], 1).cpu().numpy()
    unloaded = int((4 - (fz[on_walk] > 0.5).sum(-1)).max()) \
        if on_walk.any() else -1
    final = carry.ctrl.transition
    final_ok = bool((final.phase == 0).all().item() and np.array_equal(
        final.active_idx.cpu().numpy(), want_idx))
    tick_ms = 1e3 * wall / trans_ticks
    prof = device_profile(lambda: rollout_mod.rollout_segment(
        trans_config, params, cmd, carry, CYCLE_TICKS), CYCLE_TICKS, tick_ms)
    phase(f"gait_transition:B{TRANS_BATCH}", ticks=trans_ticks,
          kernel_launches=launches_trans, expected_launches=1 + solves,
          alive_fraction=alive, on_walk_after_segment3=int(on_walk.sum()),
          max_legs_unloaded_on_walk=unloaded,
          final_phase_none_and_table=final_ok,
          wall_s=wall, ms_per_tick=tick_ms,
          ticks_per_s=TRANS_BATCH * trans_ticks / wall, **prof,
          card=json.dumps(smi))
    if alive < 0.99 or not final_ok or unloaded > 2 or not on_walk.any():
        raise RuntimeError(f"gait_transition: alive {alive}, final "
                           f"phases/tables ok {final_ok}, {unloaded} legs "
                           f"unloaded on the walk table")

    # 15. Fixtures: the walk windows, and rows 0-3 of phase 14.
    data = np.load(WALK_FIXTURE)
    loops, rows = bench_walk.window_loops(data, dev)
    port = {}
    for sim_kind, wloop in loops.items():
        _, wtr = bench_walk.run(wloop, WALK_WINDOW_TICKS, record=True)
        for key, _, kind, _ in bench_walk.checkpoints():
            if kind == sim_kind:
                port[key] = {k: v[rows[key]].cpu().numpy()
                             for k, v in wtr.items()}
    for key, errs in bench_walk.window_errors(data, port).items():
        missed = errs.pop("missed")
        phase(f"fixture:walk_{key}", ticks=WALK_WINDOW_TICKS,
              sub_states="equal", missed_port_jax=f"{missed[0]}/{missed[1]}",
              **{k: f"{e:.3g}/{lim:.3g}" for k, (e, lim) in errs.items()})
        bad = {k: e for k, (e, lim) in errs.items() if not e <= lim}
        if bad:
            raise RuntimeError(f"fixture walk {key} mismatch: {bad}")

    data = np.load(TRANS_FIXTURE)
    n_fix = data["loop/phase"].shape[1]
    fix_res = [r for seg in seg_res[:bench_trans.FIXTURE_SEGMENTS]
               for r in seg]
    stride = bench_trans.TRACE_STRIDE
    got = {"loop/phase": t_phase[:4, :n_fix].astype(np.int8),
           "loop/active_idx": t_idx[:4, :n_fix].astype(np.int8)}
    for key in ("base_height_trace", "vel_trace", "forces_trace"):
        series = torch.cat([getattr(r, key)[:4] for r in fix_res],
                           1).cpu().numpy()
        got[f"loop/{key}"] = series[:, stride - 1::stride]
    ends = np.cumsum(bench_trans.SEGMENTS[:bench_trans.FIXTURE_SEGMENTS]) - 1
    for s_i, end in enumerate(ends):
        got[f"loop/end{s_i}/alive"] = fix_res[end].alive[:4].cpu().numpy()
        for f in bench_trans.SIM_FIELDS:
            got[f"loop/end{s_i}/{f}"] = getattr(fix_res[end].sim,
                                                f)[:4].cpu().numpy()
    errs = bench_trans.fixture_errors(got, data)
    phase("fixture:gait_transition", ticks=n_fix, phases_and_tables="equal",
          **{k.replace("loop/", ""): f"{e:.3g}/{lim:.3g}"
             for k, (e, lim) in errs.items()})
    bad = {k: e for k, (e, lim) in errs.items() if not e <= lim}
    if bad:
        raise RuntimeError(f"fixture gait_transition mismatch: {bad}")

    # 16. The robot runner from the sitting boot, on estimates.
    gc.collect()
    gc.freeze()

    def finite(*objs) -> bool:
        from quadruped_tpu_torch.utils.convert import flatten, as_numpy
        leaves = [v for o in objs for v in flatten(as_numpy(o), "").values()]
        return all(np.isfinite(v).all() for v in leaves
                   if v.dtype.kind == "f")

    bench_runner.run(bench_runner.build(RUNNER_BATCH, dev), 2)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    loop = bench_runner.build(RUNNER_BATCH, dev)
    t0 = time.perf_counter()
    loop, _ = bench_runner.run(loop, RUNNER_BOOT_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_boot = counts_after("runner:boot", "fused_admm", 1)
    if not finite(loop.sim, loop.runner):
        raise RuntimeError("runner:boot: non-finite state")
    all_up = bool((loop.runner.fsm.state == 1).all().item())
    tick_ms = 1e3 * wall / RUNNER_BOOT_TICKS
    prof = device_profile(lambda: bench_runner.run(loop, 1), 1, tick_ms)
    mirror = bench_runner.build(RUNNER_BATCH, dev,
                                config=bench_runner.default_config(dev,
                                                                   False))
    bench_runner.run(mirror, 2)                                    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    mirror = bench_runner.build(RUNNER_BATCH, dev,
                                config=bench_runner.default_config(dev,
                                                                   False))
    t0 = time.perf_counter()
    bench_runner.run(mirror, RUNNER_MIRROR_TICKS)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    launches_mirror = counts_after("runner:boot:no_shortcut", "fused_admm",
                                   1 + RUNNER_MIRROR_TICKS)
    mirror_ms = 1e3 * wall_m / RUNNER_MIRROR_TICKS
    phase(f"runner:boot:B{RUNNER_BATCH}", ticks=RUNNER_BOOT_TICKS,
          kernel_launches=launches_boot, expected_launches=1,
          all_stand_up=all_up, wall_s=wall, ms_per_tick=tick_ms,
          ticks_per_s=RUNNER_BATCH * RUNNER_BOOT_TICKS / wall,
          robot_seconds_per_wall_second=RUNNER_BATCH * RUNNER_BOOT_TICKS
          * bench_runner.DT / wall, **prof,
          no_shortcut_ticks=RUNNER_MIRROR_TICKS,
          no_shortcut_kernel_launches=launches_mirror,
          no_shortcut_ms_per_tick=mirror_ms, card=json.dumps(smi))
    if not all_up:
        raise RuntimeError("runner:boot: a scenario left STAND_UP")

    # 17. Through the STAND_UP -> LOCOMOTION switch, from the fixture.
    runner_data = np.load(bench_runner.FIXTURE)
    base, _, _ = bench_runner.window_loop(runner_data, ("switch",), dev)
    rng = np.random.default_rng(0)
    sw_vx = (0.15 + 0.15 * rng.random(RUNNER_BATCH)).astype(np.float32)
    bench_runner.run(bench_runner.tile(base, RUNNER_BATCH, sw_vx, 1.0), 2)
    torch.cuda.synchronize()
    loop = bench_runner.tile(base, RUNNER_BATCH, sw_vx, 1.0, seed=1)
    switch_at = 1500 - 1 - bench_runner.CHECKPOINTS["switch"][0]
    solves = -(-(RUNNER_SWITCH_TICKS - switch_at) // CYCLE_TICKS)
    reset_counts()
    t0 = time.perf_counter()
    loop, tr = bench_runner.run(loop, RUNNER_SWITCH_TICKS, record=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_runner = counts_after("runner:switch", "fused_admm", solves)
    fsm_tr = tr["fsm"]
    first = (fsm_tr == 2).int().argmax(1)
    switched_on_tick = bool((first == switch_at).all().item()
                            and (fsm_tr[:, switch_at:] == 2).all().item()
                            and (fsm_tr[:, :switch_at] == 1).all().item())
    if not finite(loop.sim, loop.runner):
        raise RuntimeError("runner:switch: non-finite state")
    alive_mask = bench_runner.alive(loop) > 0.5
    alive = alive_mask.float().mean().item()
    h = loop.sim.fb.position[alive_mask, 2]
    loco = (fsm_tr == 2)[..., None]
    verr = ((tr["v_est"] - tr["v_true"]).abs() * loco).sum() \
        / (loco.sum() * 3)
    tick_ms = 1e3 * wall / RUNNER_SWITCH_TICKS
    prof = device_profile(lambda: bench_runner.run(loop, CYCLE_TICKS),
                          CYCLE_TICKS, tick_ms)
    phase(f"runner:switch:B{RUNNER_BATCH}", ticks=RUNNER_SWITCH_TICKS,
          switch_tick=switch_at, switched_on_fixture_tick=switched_on_tick,
          kernel_launches=launches_runner, expected_launches=solves,
          alive_fraction=alive, final_height_min=h.min().item(),
          final_height_max=h.max().item(),
          mean_abs_v_est_error=verr.item(), tol_v_est=0.15, wall_s=wall,
          ms_per_tick=tick_ms,
          ticks_per_s=RUNNER_BATCH * RUNNER_SWITCH_TICKS / wall,
          robot_seconds_per_wall_second=RUNNER_BATCH * RUNNER_SWITCH_TICKS
          * bench_runner.DT / wall, **prof, card=json.dumps(smi))
    if (not switched_on_tick or alive < 0.99 or h.min().item() < 0.2
            or h.max().item() > 0.35 or not verr.item() < 0.15):
        raise RuntimeError(f"runner:switch: switched on the fixture's tick "
                           f"{switched_on_tick}, alive {alive}, heights "
                           f"{h.min().item()}-{h.max().item()}, v_est error "
                           f"{verr.item()}")

    # 18. The RC channel on the ground-truth SRB runner.
    from quadruped_tpu_torch.control.fsm import FsmState
    from quadruped_tpu_torch.control.rc_mode import (BUTTONS, JoyInput,
                                                     rc_init, rc_update)
    from quadruped_tpu_torch.exec import RunnerConfig

    rc_config = RunnerConfig(locomotion=LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev)))
    # Even scenarios never sit; odd ones start B, Rb, Rb on tick `down`.
    down = np.where(np.arange(RC_BATCH) % 2 == 1,
                    20 + 10 * (np.arange(RC_BATCH) // 2 % 16), -1)
    levels = np.zeros((RC_TICKS, len(BUTTONS), RC_BATCH), np.float32)
    levels[0, BUTTONS.index("btn_gait")] = 1.0
    for k, name in enumerate(("btn_stop", "btn_updown", "btn_updown")):
        rows = np.nonzero(down >= 0)[0]
        levels[down[rows] + 2 * k, BUTTONS.index(name), rows] = 1.0
    levels = torch.as_tensor(levels, device=dev)
    vx_stick = torch.full((RC_BATCH,), 0.3, device=dev)
    zero = torch.zeros(RC_BATCH, device=dev)

    def rc_loop(ticks, count_solves):
        sim, st = bench_runner.srb_boot(rc_config, params, RC_BATCH)
        rc = rc_init(RC_BATCH, device=dev)
        states, solving = [], 0
        for k in range(ticks):
            joy = JoyInput(vx=vx_stick, vy=zero, wz=zero, **{
                name: levels[k, i] for i, name in enumerate(BUTTONS)})
            rc, cmd, req, _ = rc_update(rc, joy, 0.27)
            if count_solves:
                solving += int(mpc_mod.solve_mask(
                    rc_config.locomotion.mpc, st.locomotion.mpc).any())
            sim, st, _, _ = bench_runner.srb_tick(rc_config, params, sim,
                                                  st, cmd, fsm_request=req)
            states.append(st.fsm.state.clone())
        return sim, st, torch.stack(states, 1), solving

    rc_loop(2, False)                                             # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim, st, rc_states, solving = rc_loop(RC_TICKS, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_rc = counts_after("runner:rc", "fused_admm", 1 + solving)
    rc_states = rc_states.cpu().numpy()
    sat = (rc_states == FsmState.SIT_DOWN).any(1)
    first_sit = np.where(sat, (rc_states == FsmState.SIT_DOWN).argmax(1),
                         -1)
    want_sit = np.where(down >= 0, down + 4, -1)
    rc_ok = bool(np.array_equal(first_sit, want_sit)
                 and finite(sim, st))
    phase(f"runner:rc:B{RC_BATCH}", ticks=RC_TICKS,
          scenarios_sat=int(sat.sum()), expected_sat=int((down >= 0).sum()),
          sit_down_on_scripted_ticks=rc_ok, kernel_launches=launches_rc,
          expected_launches=1 + solving, wall_s=wall,
          ms_per_tick=1e3 * wall / RC_TICKS,
          ticks_per_s=RC_BATCH * RC_TICKS / wall, card=json.dumps(smi))
    if not rc_ok:
        raise RuntimeError("runner:rc: SIT_DOWN not entered on exactly the "
                           "scripted scenarios and ticks (or non-finite)")

    # 19. The runner fixture's windows, on the card.
    loop, rows, noise = bench_runner.window_loop(runner_data, device=dev)
    _, tr = bench_runner.run(
        loop, max(w for _, w in bench_runner.CHECKPOINTS.values()),
        noise=noise, record=True)
    for key, errs in bench_runner.window_errors(runner_data, tr,
                                                rows).items():
        phase(f"fixture:runner_{key}",
              ticks=bench_runner.CHECKPOINTS[key][1],
              fsm_and_contact="equal",
              **{k: f"{e:.3g}/{lim:.3g}" for k, (e, lim) in errs.items()})
        bad = {k: e for k, (e, lim) in errs.items() if not e <= lim}
        if bad:
            raise RuntimeError(f"fixture runner {key} mismatch: {bad}")

    full_warm = full_timing[(10, "warm")]
    full_bench = bench_timing[(10, "fused_full_solve")]
    loop_bench = bench_timing[(10, "fused_admm")]
    # K3's bounds: M read and x written once; bf16 products on the tensor
    # cores; float32 as the kernel takes it, three TF32 passes, and (for the
    # record) one pass on the CUDA cores.
    dots_bytes = 2.0 * 1024 * 128 * 128 * 2
    dots_ops = 2.0 * 128 ** 3 * 1024 * 10
    dots_bound, dots_by = bound(dots_bytes, {"bf16": dots_ops})
    dots_bound_f32, dots_by_f32 = bound(2 * dots_bytes, {"tf32": 3 * dots_ops})
    dots_bound_f32_cuda_cores, _ = bound(2 * dots_bytes, {"f32": dots_ops})
    print(json.dumps({"kernels": [{
        "name": "fused_admm", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/fused_admm.cu",
        "replaces": "quadruped_tpu/solvers/pallas_admm.py:210",
        "launches": launches_slice, "max_abs_err": max_err,
        "ms": timing["warm"][0], "plain_ms": timing["warm"][1],
        "bound_ms": timing["warm"][2], "bound_by": timing["warm"][3],
        "library_ms": None,
        "ms_cold": timing["cold"][0], "plain_ms_cold": timing["cold"][1],
        "bound_ms_cold": timing["cold"][2],
        "launches_bench": bench_launches["fused_admm"],
        "launches_wbc_rollout": launches_wbc,
        "launches_whole_body": launches_wb,
        "launches_gait_transition": launches_trans,
        "launches_runner": launches_runner,
        "launches_runner_boot": launches_boot,
        "launches_runner_boot_no_shortcut": launches_mirror,
        "launches_runner_rc": launches_rc,
        "ms_boot_n192": timing["boot_n192"][0],
        "plain_ms_boot_n192": timing["boot_n192"][1],
        "bound_ms_boot_n192": timing["boot_n192"][2],
        "bound_by_boot_n192": timing["boot_n192"][3],
        "max_abs_dforce_boot_n192_N": timing["boot_n192"][4],
        "ms_bench": loop_bench[0], "plain_ms_bench": loop_bench[1],
        "bound_ms_bench": loop_bench[2]["bound_ms"],
    }, {
        "name": "fused_full_solve", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/fused_full_solve.cu",
        "replaces": "quadruped_tpu/solvers/pallas_admm.py:344",
        "launches": bench_launches["fused_full_solve"],
        "max_abs_err": full_err,
        "ms": full_warm[0], "plain_ms": full_warm[1],
        "bound_ms": full_warm[2]["bound_ms"],
        "bound_by": full_warm[2]["bound_by"],
        "library_ms": full_warm[2]["library_ms"],
        "library_call": "torch.linalg.inv on the same M (inverse stage only)",
        "inverse_ms": full_warm[2]["inverse_ms"],
        "ms_cold": full_timing[(10, "cold")][0],
        "plain_ms_cold": full_timing[(10, "cold")][1],
        "ms_bench": full_bench[0], "plain_ms_bench": full_bench[1],
        "bound_ms_bench": full_bench[2]["bound_ms"],
        "inverse_ms_bench": full_bench[2]["inverse_ms"],
        "library_ms_bench": full_bench[2]["linalg_inv_ms"],
    }, {
        "name": "unrolled_dots", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/unrolled_dots.cu",
        "replaces": "benchmarks/exp_mxu_rate.py:81",
        "launches": dots_launches,
        "max_abs_err": dots_acc["bf16"]["kernel_vs_plain"][0],
        "max_abs_err_f32": dots_acc["f32"]["kernel_vs_plain"][0],
        "ms": rate["bf16"]["kernel"][0], "plain_ms": rate["bf16"]["plain"][0],
        "bound_ms": dots_bound, "bound_by": dots_by,
        "library_ms": rate["bf16"]["matmul"][0],
        "tflops": rate["bf16"]["kernel"][1],
        "ms_f32": rate["f32"]["kernel"][0],
        "plain_ms_f32": rate["f32"]["plain"][0],
        "bound_ms_f32": dots_bound_f32, "bound_by_f32": dots_by_f32,
        "bound_ms_f32_cuda_cores": dots_bound_f32_cuda_cores,
        "library_ms_f32": rate["f32"]["matmul"][0],
        "tflops_f32": rate["f32"]["kernel"][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
