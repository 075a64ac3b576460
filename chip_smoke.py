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
     and contact flags equal);
 20. the heterogeneous fleet (quadruped_tpu_torch/benchmarks/fleet.py, the
     twin of the JAX examples/example_fleet_sweep.py): the A1, Go1,
     Aliengo and Lite3 at vx 0, 0.2, 0.4, 0.6 (stacked parameters, 16
     scenarios) tiled to B=2048, `MpcConfig(horizon=5, qp_iters=30)`, 500
     ticks of `rollout`: fused_admm once per batched MPC solve (64), at
     least 99% alive for each robot, final heights within 0.06 m of the
     command (and of their own body height for the A1, Go1 and Lite3),
     the 128 copies of each scenario within 1e-3 m; ms per tick, ticks/s,
     robot-seconds per wall second, kernels per tick and busy share;
 21. fused_admm on an MPC batch captured from the mixed fleet (per-row
     force caps) and on the same batch with mu drawn per row, against its
     plain version (the limits of phase 2), timed in turns with a batch
     of the same shape from an A1-only fleet;
 22. a B=64 fleet (the 16-scenario grid x4), 100 ticks, against each
     robot run alone with one-robot parameters;
 23. `utils.checkpoint.checkpointed_rollout` of the B=64 fleet in two
     50-tick segments, called again after the first as after a crash: the
     resumed carry bitwise the uninterrupted run's; a trace save / load
     round trip (`utils.trace`);
 24. fixture: the JAX fleet and multi-gait rollouts of
     tests/data/fleet_a1.npz at the CPU test's limits;
 25. the bench's seeded route: `bench.build_bench` at B=8192, H=10 and
     H=16, route `loop` cold and with `minv_reuse` (the boot's inverse
     carry seeds M^{-1}): fused_admm once per update, the seeded update's
     first-step forces within 3% (H=10) / 1% (H=16) m*g of the cold
     update's; the inverse stage of each timed alone (CUDA events), the
     seeded one with and without the rescue of diverged polishes, the
     Woodbury capacitance scan and its share, how many polishes diverge
     without the rescue, max|I - MX| of both; solves/s of both routes;
 26. a carried chain at B=2048: 40 cadence solves (`bench_problems` 15 ms
     apart), seeded (with the rescue), cold, and a control (cold with two
     float32 polish steps), each against a 400-iteration relaxed solve of
     the same problem: every step finite, the seeded error averaged over
     the batch never more than 1% m*g over the cold one (the JAX
     test_long_chain_no_accumulation, per step over the batch), the
     per-scenario excess of the seeded and the control chain printed,
     fused_admm once per solve;
 27. fused_admm started from a carried z0 (the bf16 head's iterate after
     4 iterations, B=2048, n=120, 20 iterations) against its plain
     version (the limits of phase 2), timed in turns with K1 without z0;
     `cone_qp.solve(bf16_iters=4, iters=24)` on the card against the same
     solve on the CPU (B=256) at tests/test_torch_bf16_iters.py's limits,
     fused_admm once for the float32 tail;
 28. the dense condensation (`condense.condense_cost`) against the
     structured one on the card, B=2048, H=10: max |diff| / max |value| of
     P and q within 1e-5.
Phases 29-35 run the fleet of phase 20 (A1, Go1, Aliengo, Lite3, a
quarter of the batch each; benchmarks/fleet_paths.py, each robot
commanded its nominal body height less 1 cm) through every other path at
that path's batch and configuration:
 29-34. `fleet:velocity` and `fleet:position` (B=2048, 40 ticks each),
     `fleet:walk` (B=256 on the whole-body sim, 60 ticks, the first of
     which replans the pose with the SQP), `fleet:wbc` (B=1024,
     `MpcConfig(horizon=10)`, `WbcConfig()`, 100 ticks), `fleet:wholebody`
     (B=1024, H10, 100 ticks) and `fleet:runner` (B=1024, the STAND_UP
     ramp from the sitting boot on estimates, 100 ticks): ms per tick,
     ticks/s, robot-seconds per wall second, kernels per tick and busy
     share (over one tick, one MPC cycle of 8 where the path solves),
     fused_admm once per batched MPC solve (the boot's cold start
     included; none in VELOCITY, POSITION, the walk and the ramp), each
     robot's alive share (for the runner: not dropped to PASSIVE) and
     final height, every state finite; a robot whose alive share is below
     0.99 is run alone on its scenarios, and its fleet share may not be
     more than 0.01 below that;
 35. fused_admm on the whole-body fleet's warm MPC batch (B=1024, n=120,
     per-row force caps of four robots) against its plain version (the
     limits of phase 2), timed in turns with the same batch from the A1
     alone; then each path's B=64 fleet (16 scenarios a robot, and the
     runner also booted standing in LOCOMOTION, `runner_trot`: K1 on the
     runner's MPC) over 12 ticks against each robot run alone at B=16
     with one-robot parameters, on heights and joint angles at phase 22's
     limits on the SRB sim and at the whole-body loop's CPU limits on the
     whole-body sim (FLEET_CHECK_TOL), K1 once per solve.
Phases 36-39 run the host bridge, the hil tick and distributed/:
 36. `bridge`: native/robot_bridge.cpp built with g++ into
     quadruped_tpu_torch/_build/ (its seconds; native/libqtpu_bridge.so
     left as it was), then one loopback round trip through `RobotBridge`
     per wire mode (native, unitree, deeprobotics): the decoded joint
     angles of a packet written at the spec offsets, and the command's
     torques clipped to 23 N m on the wire;
 37. `hil:B1` and `hil:B16` (benchmarks/hil_latency.py, the twin of the
     JAX benchmarks/hil_latency.py): the feeder -> bridge ->
     `locomotion_step` (H=10, 24 iterations, 120-iteration boot) -> send
     loop, 300 ticks at the cadence (solve and hold ticks apart) and 300
     with `solve_mode="always"`: p50, p99 and max in ms, CUDA kernels on a
     solve tick and a hold tick, K1 once per solve tick and never on a hold
     tick, every command finite and every sink served every tick;
     `within_2ms_tick_budget` and `within_15ms_cadence_budget` printed, not
     asserted; K1 at B=1 and B=16 against its plain version and timed;
 38. `distributed:dryrun`: `entry.dryrun_multichip(1)` on a one-rank NCCL
     group at `MpcConfig()` (K1 twice: the boot and the step's solve), its
     forces bit for bit the same step with no mesh, K1 at its two shapes
     timed; then the twin of the JAX
     test_sharded_closed_loop_rollout_matches_unsharded: B=16, 125 ticks,
     `shard_batch` over the mesh, bit for bit the unsharded rollout, K1
     1 + 16 times;
 39. `distributed:sp`: `solve_cone_sp` at sp = 1 against `cone_qp.solve`
     on 8 bench problems at the JAX test_solver_sp quality bound, and one
     `scaling_report` reading at one rank (B=1024) through
     `sharded_solve_stats`.
The check phases print no time: 4, 9, the cross-simulator check of 11,
the fixtures of 12, the walk windows of 15, 19, 22-24 and the per-path
B=64 fleets of 35. They run after phase 35 and before phase 36, split
over CHECK_PROCESSES processes on the card at once (this one and workers
started as `chip_smoke.py --checks NAME,...`; the line `checks` names the
groups), so their lines come in that order; the phases that print a time
run alone.
Every phase line ends with its wall time since the previous line. The last
two lines are a JSON object describing the kernels (with each
kernel's bound: the larger of the bytes it must move over the memory rate
and its operations over the peak rate of their type) and the device JSON
object. There is no CPU path: without a CUDA device the script fails
before printing a result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
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
# The seeded route (phases 25-26): the seeded update's forces against the
# cold update's on the same problems, at the CPU bench test's limits
# (tests/test_torch_bench.py TOL, fractions of m*g by horizon); the carried
# chain at B=2048 over 40 cadence solves, each solve's first-step forces
# against a 400-iteration relaxed solve of the same problem: at every
# step the seeded path's error, averaged over the batch, may exceed the
# cold path's by at most 1% m*g (the JAX test's limit, which it applies to
# one scenario). Per scenario the two chains part by chain noise: a cold
# chain with a better inverse (two float32 polish steps) exceeds the cold
# route on some scenario and step by more than the seeded chain does, so
# the phase prints both spreads and holds the batch mean.
MINV_TOL = {10: 0.03, 16: 0.01}
CHAIN_BATCH, CHAIN_STEPS, CHAIN_EXCESS = 2048, 40, 0.01
# The share of seeded solves whose polish diverged and took the cold
# inverse (`seed_rescue`); a seeded path that leaves the pin flips to the
# rescue (no Woodbury step) holds the forces and fails this.
RESCUE_MAX_SHARE = 0.01
# The bf16 head on the card against the same solve on the CPU (phase 27):
# the CPU test's limits against JAX (tests/test_torch_bf16_iters.py):
# first-step forces 0.5% m*g, every force 3% m*g, duals 1e-3 + 1e-3 |y|.
BF16_BATCH = 256
# Dense against structured condensation (phase 28), max |diff| over max
# |value| of P and of q (1e-5; 3e-7 on the CPU at B=256).
DENSE_REL = 1e-5
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
# The fleet (phases 20-24): the example's sweep tiled to B=2048 over its 500
# ticks; the JAX test's bound on final heights, 0.06 m: off the commanded
# 0.27 m for every robot, and off each robot's own body height for the
# robots of the JAX test (the Aliengo, nominally 0.37 m, stands where the
# grid's command puts it, as in the JAX package); the copies of one
# scenario must agree. The B=64 fleet against each robot alone over 100
# ticks, at 10x the spread of JAX's own one-float32-step nudges over the
# 150-tick fleet window (tests/test_torch_scenarios.py; a wrong broadcast
# moves heights by centimetres and forces by tens of newtons).
FLEET_REPEATS, FLEET_TICKS = 128, 500
FLEET_GRID = 16              # 4 robots x 4 speeds
FLEET_BATCH = FLEET_GRID * FLEET_REPEATS
FLEET_HEIGHT_TOL, FLEET_COPY_TOL = 0.06, 1e-3
FLEET_JAX_TEST_ROBOTS = ("a1", "go1", "lite3")
FLEET_SINGLE_BATCH, FLEET_SINGLE_TICKS = 64, 100
FLEET_SINGLE_TOL = {"base_height_trace": 7.3e-5, "vel_trace": 1.9e-3,
                    "forces_trace": 7.6, "q": 6.7e-4}
# The fleet on the other paths (phases 29-35): (path, B, ticks), the four
# robots a quarter of the batch each; the B=64 fleet of each path (16
# scenarios a robot) against each robot alone at B=16 over 12 ticks (cut
# from 20 to keep the new phases under 150 s; the walk's first tick
# replans), on the base heights and the final joint angles. On the SRB sim
# at the limits of phase 22. On the whole-body sim the card's batched
# kernels round a row's last bit by the batch size (the B=64 fleet and
# the A1 alone at B=16 part by 5e-10 rad of q on the first walk tick) and
# the stiff contact grows it (1.1e-2 rad of q after 20 walk ticks, 1.7e-3
# in the trot); there at the limits tests/test_torch_whole_body.py holds
# the whole-body loop to between two implementations (CLOSED_TOL: height
# 5e-4 m, q 4e-2 rad). The whole-body fleet's batch whose warm MPC solve
# K1 is timed on.
FLEET_PATHS = (("velocity", 2048, 40), ("position", 2048, 40),
               ("walk", 256, 60), ("wbc", 1024, 100),
               ("wholebody", 1024, 100), ("runner", 1024, 100))
GRID_CHECK, FLEET_CHECK_TICKS = 64, 12
FLEET_CHECK_TOL = {
    "srb": {"height": FLEET_SINGLE_TOL["base_height_trace"],
            "q": FLEET_SINGLE_TOL["q"]},
    "whole_body": {"height": 5e-4, "q": 4e-2}}
WB_FLEET_BATCH = 1024
# The check phases (`check_block`): processes on the card at once (the
# checks are launch-bound and leave the card idle most of the time), a
# worker's limit, and each check's seconds in a serial run of the script
# (NVIDIA H100 80GB HBM3, 700 W), which balance the split.
CHECK_PROCESSES, CHECK_TIMEOUT_S = 3, 600
CHECK_SECONDS = {
    "fixture": 0.9, "fixture:velocity": 53.1, "fixture:position": 37.7,
    "whole_body:cross_srb": 66.2, "fixture:wbc": 11.1,
    "fixture:whole_body": 10.2, "fixture:walk": 39.0,
    "fixture:runner": 21.5, "fleet:vs_single": 19.0, "fixture:fleet": 7.2,
    "fleet:velocity:vs_single": 14.0, "fleet:position:vs_single": 15.7,
    "fleet:walk:vs_single": 22.1, "fleet:wbc:vs_single": 3.2,
    "fleet:wholebody:vs_single": 4.0, "fleet:runner:vs_single": 3.9,
    "fleet:runner_trot:vs_single": 4.8}
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


# 36-39. The host bridge, the hil tick at B=1 and B=16, distributed/ on a
# one-rank NCCL group.
HIL_FLEETS = (1, 16)
# Ticks of the cadence run and of the solve_mode="always" run (the JAX
# script's default).
HIL_TICKS = {"cadence": 300, "always": 300}
DRY_TICKS, DRY_BATCH = 125, 16
SP_BATCH, SCALING_BATCH = 8, 1024


def _free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _crc32_unitree(data: bytes) -> int:
    """Unitree CRC-32 (poly 0x04c11db7, init 0xFFFFFFFF, word-wise, no
    reflection) over every 32-bit word but the trailing CRC word."""
    import struct

    crc = 0xFFFFFFFF
    for i in range((len(data) >> 2) - 1):
        (word,) = struct.unpack_from("<I", data, 4 * i)
        for bit in range(31, -1, -1):
            crc = ((crc << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 if crc & 0x80000000
                                               else 0)
            if word >> bit & 1:
                crc ^= 0x04C11DB7
    return crc


def wire_state_packet(mode: str) -> bytes:
    """A state packet of each wire protocol, written at the spec offsets
    (nothing shared with the C++ codec): joint j at 0.3 + 0.01 j in
    `native` and `unitree`, wire joint w at 1.0 + 0.01 w in
    `deeprobotics`."""
    import struct

    if mode == "native":
        vals = np.zeros(51, np.float32)
        vals[0], vals[1] = 5.0, 1.0
        vals[11:23] = 0.3 + 0.01 * np.arange(12)
        vals[47:51] = 30.0
        return vals.tobytes()
    if mode == "unitree":
        buf = bytearray(891)
        buf[0] = 0xFF
        struct.pack_into("<4f", buf, 10, 1.0, 0.0, 0.0, 0.0)
        for j in range(20):
            buf[63 + 38 * j] = 0x0A
            struct.pack_into("<f", buf, 63 + 38 * j + 1, 0.3 + 0.01 * j)
        struct.pack_into("<4h", buf, 823, 10, 20, 30, 40)
        struct.pack_into("<I", buf, 839, 123456)
        struct.pack_into("<I", buf, 887, _crc32_unitree(bytes(buf)))
        return bytes(buf)
    payload = bytearray(336)
    struct.pack_into("<I", payload, 0, 2500)
    for w in range(12):
        struct.pack_into("<4f", payload, 44 + 16 * w, 1.0 + 0.01 * w, 0.0,
                         0.0, 35.0)
    return struct.pack("<III", 0x0906, 336, 1 | (7 << 8)) + bytes(payload)


def wire_round_trip(mode: str) -> dict:
    """One loopback round trip through the port's RobotBridge in `mode`:
    the decoded joint angles against the packet's, and the command's
    torques (50 N m asked) clipped to the 23 N m limit on the wire."""
    import socket
    import struct

    from quadruped_tpu_torch.runtime import RobotBridge

    mcu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mcu.bind(("127.0.0.1", 0))
    mcu.settimeout(2.0)
    state_port = _free_udp_port()
    bridge = RobotBridge(recv_port=state_port,
                         send_port=mcu.getsockname()[1], torque_limit=23.0,
                         wire_mode=mode)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        pkt = wire_state_packet(mode)
        deadline, n = time.time() + 2.0, 0
        while n == 0 and time.time() < deadline:
            tx.sendto(pkt, ("127.0.0.1", state_port))
            time.sleep(0.01)
            n, state = bridge.get_state()
        if n == 0:
            raise RuntimeError(f"bridge:{mode}: no state decoded")
        j = np.arange(12)
        wire = j + 3 - 6 * ((j // 3) % 2)      # FR<->FL, RR<->RL swaps
        want_q = (1.0 + 0.01 * wire if mode == "deeprobotics"
                  else 0.3 + 0.01 * j)
        dq_state = float(np.abs(state["q"] - want_q).max())
        q = 0.1 * j
        if not bridge.send_command(q, np.full(12, 60.0), np.zeros(12),
                                   np.full(12, 5.0), np.full(12, 50.0)):
            raise RuntimeError(f"bridge:{mode}: send failed")
        data, _ = mcu.recvfrom(4096)
        if mode == "native":
            cmd = np.frombuffer(data, np.float32)
            q_sent, tau = cmd[:12], cmd[48:60]
        elif mode == "unitree":
            if struct.unpack_from("<I", data, 726)[0] != _crc32_unitree(data):
                raise RuntimeError("bridge:unitree: LowCmd CRC")
            rows = [struct.unpack_from("<5f", data, 11 + 33 * k)
                    for k in range(12)]
            q_sent = np.array([r[0] for r in rows])
            tau = np.array([r[2] for r in rows])
        else:
            rows = [struct.unpack_from("<5f", data, 12 + 20 * int(w))
                    for w in wire]
            q_sent = np.array([r[0] for r in rows])
            tau = np.array([r[2] for r in rows])
        out = dict(bytes_in=len(pkt), bytes_out=len(data),
                   max_abs_dq_state=dq_state,
                   max_abs_dq_command=float(np.abs(q_sent - q).max()),
                   tau_on_wire=json.dumps(sorted(set(np.round(tau, 4)
                                                     .tolist()))))
        if not (dq_state < 1e-5 and out["max_abs_dq_command"] < 1e-6
                and np.all(tau == np.float32(23.0))):
            raise RuntimeError(f"bridge:{mode}: round trip {out}")
        return out
    finally:
        bridge.close()
        mcu.close()
        tx.close()


def capture_k1(fn) -> list:
    """(K1 operands, kwargs) of every cone_qp.solve that fn() runs, as the
    solve hands them to the kernel."""
    from quadruped_tpu_torch.solvers import cone_qp

    got = []
    solve = cone_qp.solve
    cone_qp.solve = lambda prob, **kw: got.append((prob, kw)) or \
        solve(prob, **kw)
    try:
        fn()
    finally:
        cone_qp.solve = solve
    out = []
    for prob, kw in got:
        inp = cone_qp.admm_inputs(prob, rho=kw.get("rho", cone_qp.RHO_CONE),
                                  x0=kw.get("x0"), y0=kw.get("y0"))
        args = tuple(inp[:8])
        out.append((args, dict(iters=kw["iters"], sigma=cone_qp.SIGMA,
                               alpha=kw.get("alpha", cone_qp.ALPHA),
                               accel_restart=kw.get("accel_restart", 0))))
    return out


def kernel_device_ms(fn, reps: int = 50) -> float:
    """Device time in ms of one call of fn() among `reps` back to back,
    with the host's work taken out: a sleep kernel holds the stream while
    the host enqueues every call, so the events time the kernels alone
    (the time of a kernel whose call costs the host more than the kernel
    takes, as at a batch of a few problems)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~25 ms of SM clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_reading(where: str, args, kw) -> dict:
    """K1 against its plain version on these operands (KERNEL_ATOL /
    KERNEL_RTOL); its device time (`kernel_device_ms`) and its time a call
    back to back (CUDA events, the wrapper's host work included), the
    plain version's and its bound."""
    from quadruped_tpu_torch.solvers import fused_admm
    from quadruped_tpu_torch.utils import card

    xk, yk = fused_admm.fused_admm(*args, **kw)
    xr, yr = fused_admm.fused_admm_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
        raise RuntimeError(f"fused_admm output not finite ({where})")
    torch.testing.assert_close(xk, xr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(yk, yr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    batch, n = args[1].shape
    ms = kernel_device_ms(lambda: fused_admm.fused_admm(*args, **kw))
    per_call = card.time_ms(lambda: fused_admm.fused_admm(*args, **kw), 50)
    plain_ms = card.time_ms(
        lambda: fused_admm.fused_admm_reference(*args, **kw), 3)
    b_ms, b_by = bound(*admm_work(batch, n, kw["iters"]))
    return dict(batch=batch, n=n, iters=kw["iters"],
                max_abs_err=max((xk - xr).abs().max().item(),
                                (yk - yr).abs().max().item()),
                ms=ms, ms_per_call=per_call, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms)


def phases_bridge_hil_distributed(dev, smi: str) -> dict:
    """Phases 36-39; returns the K1 readings of the kernels line."""
    import torch.distributed as dist

    from quadruped_tpu_torch import entry
    from quadruped_tpu_torch.benchmarks import hil_latency as hil
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.distributed import (make_mesh, shard_batch,
                                                 solve_cone_sp)
    from quadruped_tpu_torch.distributed.scaling import (scaling_report,
                                                         sharded_solve_stats)
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout import rollout
    from quadruped_tpu_torch.solvers import cone_qp, fused_admm, problems
    from quadruped_tpu_torch.utils import host_build

    k1 = fused_admm.fused_admm
    out = {}

    # 36. The host library from native/robot_bridge.cpp, into _build/,
    # and one loopback round trip per wire mode.
    jax_so = ROOT / "native" / "libqtpu_bridge.so"
    before = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    path, _, gxx_s = host_build.build_host_library(force=True)
    after = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    if after != before or path.parent != ROOT / "quadruped_tpu_torch" / \
            "_build":
        raise RuntimeError("bridge: the build wrote outside _build/")
    trips = {mode: wire_round_trip(mode)
             for mode in ("native", "unitree", "deeprobotics")}
    phase("bridge", library=path.relative_to(ROOT), gxx_seconds=gxx_s,
          jax_library_untouched=True,
          round_trips=json.dumps(trips, sort_keys=True))

    # 37. The hil tick at fleets of 1 and 16: the cadence (solve and hold
    # ticks apart) and solve_mode="always".
    for n in HIL_FLEETS:
        line = {}
        for mode in hil.MODES:
            with hil.HilRig(n, dev, solve_mode=mode) as rig:
                rig.run(0, warmup=3)
                k1.launches = 0
                res = rig.run(HIL_TICKS[mode], warmup=0, record=True)
                launches = k1.launches
                if not (res["received"] == 1).all():
                    raise RuntimeError(f"hil:B{n} {mode}: a sink missed a "
                                       f"command")
                if not np.isfinite(res["commands"]).all():
                    raise RuntimeError(f"hil:B{n} {mode}: a command is not "
                                       f"finite")
                if launches != int(res["solve"].sum()) or \
                        not (res["k1"] == res["solve"]).all():
                    raise RuntimeError(f"hil:B{n} {mode}: K1 launches "
                                       f"{launches}, solve ticks "
                                       f"{int(res['solve'].sum())}")
                line[mode] = dict(hil.summarize(res), k1_launches=launches)
                if mode == "cadence":
                    # Kernels on a solve tick (the first of a run) and over
                    # one MPC cycle of 8; the "always" run's ticks are
                    # solve ticks.
                    solve_ms = line[mode]["solve_ticks"]["p50_ms"]
                    prof = device_profile(lambda: rig.run(1, warmup=0), 1,
                                          solve_ms)
                    cycle = device_profile(
                        lambda: rig.run(8, warmup=0), 8,
                        line[mode]["all_ticks"]["mean_ms"])
                    solve_k = prof["kernels_per_tick"]
                    line[mode].update(
                        kernels_solve_tick=solve_k,
                        kernels_hold_tick=(
                            "not measured" if isinstance(solve_k, str) else
                            (8 * cycle["kernels_per_tick"] - solve_k) / 7),
                        device_busy_share_solve_tick=prof[
                            "device_busy_share"])
                    line["k1"] = k1_reading(f"hil:B{n}", *capture_k1(
                        lambda: rig.run(1, warmup=0))[-1])
                    tag = f"hil_b{n}"
                    out.update({f"launches_{tag}": launches,
                                **{f"{k}_{tag}": line["k1"][k] for k in
                                   ("ms", "ms_per_call", "plain_ms",
                                    "bound_ms", "max_abs_err")}})
        phase(f"hil:B{n}", ticks=json.dumps(HIL_TICKS),
              cadence=json.dumps(line["cadence"]),
              always=json.dumps(line["always"]),
              k1=json.dumps(line["k1"]), card=json.dumps(smi))

    # 38. dryrun_multichip(1) on a one-rank NCCL group against the same
    # step with no mesh; the B=16 sharded closed loop against the same
    # batch unsharded.
    k1.launches = 0
    dry = entry.dryrun_multichip(1)
    dry_launches = k1.launches
    if dry_launches != 2 or dist.get_backend() != "nccl":
        raise RuntimeError(f"distributed:dryrun: K1 launches {dry_launches} "
                           f"(expected 2), backend {dist.get_backend()}")
    cfg = entry.dryrun_config(dev)
    built = {}

    def plain_step():
        built["v"] = entry.dryrun_build(cfg, 2, slice(0, 2), dev)
        built["f"] = entry.dryrun_step(cfg, *built["v"])[2]

    dry_ops = capture_k1(plain_step)
    if not torch.equal(dry.forces, built["f"]):
        raise RuntimeError("distributed:dryrun: forces differ from the step "
                           "with no mesh")
    dry_boot = k1_reading("dryrun boot", *dry_ops[0])
    dry_warm = k1_reading("dryrun warm", *dry_ops[1])
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(dev))
    params = a1_params(dev)
    rng = np.random.default_rng(7)
    cmds = TwistCommand.constant(
        vx=rng.uniform(0.1, 0.5, DRY_BATCH).astype(np.float32), device=dev)
    mesh = make_mesh(1)
    k1.launches = 0
    t0 = time.perf_counter()
    got = rollout(config, params, shard_batch(mesh, cmds), DRY_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roll_launches = k1.launches
    want = rollout(config, params, cmds, DRY_TICKS)
    expected = 1 + -(-DRY_TICKS // config.mpc.ticks_per_solve)
    equal = all(torch.equal(a, b) for a, b in (
        (got.alive, want.alive), (got.sim.position, want.sim.position),
        (got.forces_trace, want.forces_trace)))
    phase("distributed:dryrun", world_size=dist.get_world_size(),
          backend=dist.get_backend(), batch=2, stat=dry.stat.item(),
          kernel_launches=dry_launches, forces_equal_no_mesh=True,
          k1_boot=json.dumps(dry_boot), k1_warm=json.dumps(dry_warm),
          rollout_batch=DRY_BATCH, rollout_ticks=DRY_TICKS,
          rollout_kernel_launches=roll_launches,
          rollout_expected_launches=expected,
          rollout_bitwise_equal_unsharded=equal,
          rollout_alive=got.alive.mean().item(), rollout_wall_s=wall,
          card=json.dumps(smi))
    if not equal or roll_launches != expected or got.alive.min() < 1.0:
        raise RuntimeError("distributed:dryrun: sharded rollout differs, or "
                           "K1 launched otherwise, or a robot fell")
    out.update(launches_dryrun=dry_launches, ms_dryrun=dry_warm["ms"],
               ms_per_call_dryrun=dry_warm["ms_per_call"],
               plain_ms_dryrun=dry_warm["plain_ms"],
               bound_ms_dryrun=dry_warm["bound_ms"],
               ms_dryrun_boot=dry_boot["ms"],
               bound_ms_dryrun_boot=dry_boot["bound_ms"],
               max_abs_err_dryrun=max(dry_warm["max_abs_err"],
                                      dry_boot["max_abs_err"]),
               launches_sharded_rollout=roll_launches)

    # 39. solve_cone_sp at sp = 1 against cone_qp.solve, at the JAX
    # test's quality bound; one scaling_report reading at one rank.
    prob, _ = problems.bench_problems(SP_BATCH, 10, device=dev)
    conv = cone_qp.solve(prob, iters=2000)
    ref = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20)
    got_sp = solve_cone_sp(mesh, prob, iters=24)
    err_ref = (ref.x - conv.x).abs().max().item()
    err_got = (got_sp.x - conv.x).abs().max().item()
    gap = (got_sp.x - ref.x).abs().max().item()

    def build(batch, m):
        p, _ = problems.bench_problems(batch, 10, device=dev)
        boot = cone_qp.solve(p, iters=400, alpha=1.6)

        def solve(pp):
            return cone_qp.solve(pp, iters=24, alpha=1.0, accel_restart=20,
                                 x0=boot.x, y0=boot.y).x[:, :12].reshape(
                                     -1, 4, 3)

        return sharded_solve_stats(m, solve), (shard_batch(m, p),)

    report = scaling_report(build, SCALING_BATCH, 1, reps=20)
    phase("distributed:sp", sp=1, batch=SP_BATCH, err_vs_converged=err_got,
          err_solve_vs_converged=err_ref, max_abs_vs_solve=gap,
          bound="err < 1.2 err_solve + 0.5, gap < 2.0",
          scaling=json.dumps(report), scaling_batch=SCALING_BATCH,
          card=json.dumps(smi))
    if not (err_got < 1.2 * err_ref + 0.5 and gap < 2.0):
        raise RuntimeError("distributed:sp: solve_cone_sp off the bound")
    dist.destroy_process_group()
    return out



def hold(name: str, got: dict, want: dict, tol: dict, **extra):
    """max |got - want| per key of `tol`, printed beside its limit on the
    line `name`; raises if any is over its limit."""
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in tol}
    phase(name, **extra,
          **{k: f"{e:.3g}/{tol[k]:g}" for k, e in errs.items()})
    bad = {k: e for k, e in errs.items() if not e <= tol[k]}
    if bad:
        raise RuntimeError(f"{name} mismatch: {bad}")


def kernel_wrappers() -> dict:
    """The wrapper of each kernel of the port, by name; each counts its
    launches in `.launches`."""
    from quadruped_tpu_torch.benchmarks import mxu_rate
    from quadruped_tpu_torch.solvers import fused_admm, fused_full_solve

    return {"fused_admm": fused_admm.fused_admm,
            "fused_full_solve": fused_full_solve.fused_full_solve,
            "unrolled_dots": mxu_rate.unrolled_dots}


def reset_counts():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def counts_after(path: str, kernel: str, expected=None) -> int:
    """The launch counts of the run of `path` since reset_counts(): only
    `kernel` launched, `expected` times (at least once if None)."""
    counts = {name: w.launches for name, w in kernel_wrappers().items()}
    n = counts[kernel]
    others = sum(counts.values()) - n
    if others or n == 0 or (expected is not None and n != expected):
        raise RuntimeError(f"{path}: kernel launches {counts}, expected "
                           f"{expected or 'some'} of {kernel} only")
    return n


def path_launches(name: str, expected: int) -> int:
    """The kernel launches since reset_counts(): K1 `expected` times (the
    boot's cold start and one a batched MPC solve), or none where the path
    solves no MPC."""
    if expected:
        return counts_after(name, "fused_admm", expected)
    counts = {k: w.launches for k, w in kernel_wrappers().items()}
    if any(counts.values()):
        raise RuntimeError(f"{name} launched kernels: {counts}")
    return 0


def mode_config(mode, dev):
    """The force-balance configuration of VELOCITY or POSITION mode
    (phases 8 and 9)."""
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.control.stance_force_balance import \
        ForceBalanceConfig
    from quadruped_tpu_torch.gait import TROT

    return LocomotionConfig(mpc=mpc_mod.MpcConfig(),
                            swing=swing_mod.SwingConfig(mode=mode),
                            gait=TROT(dev), mode=mode,
                            force_balance=ForceBalanceConfig())


# The check phases: the card against the JAX package's fixtures, the
# cross-simulator check, and each fleet against its robots run alone. They
# print no time, so they run together after phase 35, split over
# CHECK_PROCESSES processes on the card at once: this one, and workers
# started as `chip_smoke.py --checks NAME,...`. Each check is one function
# of the device; CHECK_SECONDS (their seconds in a serial run on the card,
# NVIDIA H100 80GB HBM3 at 700 W) balances the split.


def check_fixture(dev):
    """4. The JAX fixture, on the card."""
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced

    params = a1_params(dev)
    config = LocomotionConfig(mpc=mpc_mod.MpcConfig(horizon=10),
                              swing=swing_mod.SwingConfig(),
                              gait=ADVANCED_TROT(dev))
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



def check_modes_fixture(dev, which: str):
    """9. The JAX modes fixture of VELOCITY or POSITION mode, on the
    card."""
    from quadruped_tpu_torch.control.desired_state import (ControlMode,
                                                           TwistCommand)
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod

    params = a1_params(dev)
    mode = {"velocity": ControlMode.VELOCITY,
            "position": ControlMode.POSITION}[which]
    data = np.load(MODES_FIXTURE)
    want = {k[len(which) + 1:]: data[k] for k in data.files
            if k.startswith(which + "_")}
    ticks, step = int(want["ticks"]), int(data["trace_stride"])
    fres = rollout_mod.rollout(mode_config(mode, dev), params,
                               TwistCommand.constant(
                                   vx=want["vx"], body_height=0.27,
                                   device=dev), ticks)
    got = {k: getattr(fres.sim, k).cpu().numpy() for k in FIXTURE_TOL
           if hasattr(fres.sim, k)}
    got["base_height_trace"] = \
        fres.base_height_trace[:, step - 1::step].cpu().numpy()
    got["vel_trace"] = fres.vel_trace[:, step - 1::step].cpu().numpy()
    if not np.array_equal(fres.alive.cpu().numpy(), want["alive"]):
        raise RuntimeError(f"fixture {which}: alive mask differs")
    hold(f"fixture:{which}", got, want, MODES_FIXTURE_TOL, ticks=ticks)


def check_cross_srb(dev):
    """11. The whole-body loop against the SRB rollout at B=64 over 600
    ticks (the last 200 ticks' mean height and vx)."""
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod

    params = a1_params(dev)
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



def check_wbc_fixture(dev):
    """12. The JAX fixture of the WBC rollout and of one WBC tick."""
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control import wbc as wbc_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod

    params = a1_params(dev)
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


def check_whole_body_fixture(dev):
    """12. The JAX fixture of the whole-body loop."""
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT

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


def check_walk_windows(dev):
    """15. The walk fixture's windows: the first WALK_WINDOW_TICKS ticks
    of each."""
    from quadruped_tpu_torch.benchmarks import walk as bench_walk

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


def check_runner_windows(dev):
    """19. The runner fixture's windows, on the card."""
    from quadruped_tpu_torch.benchmarks import runner as bench_runner

    runner_data = np.load(bench_runner.FIXTURE)
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


def check_fleet_vs_single(dev):
    """22. Each robot of a B=64 fleet against the same robot run alone with
    one-robot parameters; 23. the checkpointed rollout of that fleet."""
    from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.gait import named_gait
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.sim import rollout as rollout_mod
    from quadruped_tpu_torch.utils import checkpoint, tree
    from quadruped_tpu_torch.utils.trace import (compare_traces, load_trace,
                                                 save_trace)

    vs = bench_fleet.build(FLEET_SINGLE_BATCH // FLEET_GRID, dev)
    vres = bench_fleet.run(vs, FLEET_SINGLE_TICKS)
    errs = dict.fromkeys(FLEET_SINGLE_TOL, 0.0)
    for r in bench_fleet.ROBOTS:
        rows = torch.tensor([x == r for x in vs.robots], device=dev)
        vx = vs.cmd.linear[rows, 0]
        alone = rollout_mod.rollout(
            bench_fleet.config(named_gait(bench_fleet.GAITS[0], dev)),
            named_params(r, dev),
            TwistCommand.constant(vx=vx, device=dev), FLEET_SINGLE_TICKS)
        for k in FLEET_SINGLE_TOL:
            a = getattr(alone, k) if k != "q" else alone.sim.q
            b = getattr(vres, k)[rows] if k != "q" else vres.sim.q[rows]
            errs[k] = max(errs[k], (a - b).abs().max().item())
    hold(f"fleet:vs_single:B{FLEET_SINGLE_BATCH}", errs,
         dict.fromkeys(errs, 0.0), FLEET_SINGLE_TOL,
         ticks=FLEET_SINGLE_TICKS, robots=json.dumps(bench_fleet.ROBOTS))

    # 23. Checkpointed rollout of the B=64 fleet over two segments,
    # interrupted after the first, against the uninterrupted run; then a
    # trace round trip.
    ckpt_dir = ROOT / "quadruped_tpu_torch" / "_build" / "fleet_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    seg = FLEET_SINGLE_TICKS // 2
    checkpoint.checkpointed_rollout(vs.config, vs.params, vs.cmd, seg, seg,
                                    str(ckpt_dir))
    resumed, last = checkpoint.checkpointed_rollout(
        vs.config, vs.params, vs.cmd, 2 * seg, seg, str(ckpt_dir))
    carry = rollout_mod.rollout_init(vs.config, vs.params,
                                     FLEET_SINGLE_BATCH)
    for _ in range(2):
        carry, last_u = rollout_mod.rollout_segment(vs.config, vs.params,
                                                    vs.cmd, carry, seg)
    a, b = (dict(tree.leaves(x)) for x in (resumed, carry))
    bitwise = a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)
    trace_path = str(ckpt_dir / "trace.npz")
    save_trace(trace_path, last, meta={"ticks": seg})
    back, meta = load_trace(trace_path, like=last)
    trace_diff = compare_traces(last, back, atol=0.0)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase(f"fleet:checkpoint:B{FLEET_SINGLE_BATCH}", segments=2,
          segment_ticks=seg, resumed_step=resumed.step,
          bitwise_equal_uninterrupted=bitwise,
          last_segment_equal=bool(torch.equal(last.base_height_trace,
                                              last_u.base_height_trace)),
          trace_roundtrip_max_abs=trace_diff["max"],
          trace_meta=json.dumps(meta))
    if not (bitwise and resumed.step == 2 * seg
            and trace_diff["within_tol"]):
        raise RuntimeError("fleet:checkpoint: the resumed run is not bitwise "
                           "the uninterrupted one, or the trace round trip "
                           "changed it")


def check_fleet_fixture(dev):
    """24. The JAX fleet fixture (tests/data/fleet_a1.npz), on the card."""
    from quadruped_tpu_torch.benchmarks import fleet as bench_fleet

    fleet_data = np.load(bench_fleet.FIXTURE)
    for case in sorted(bench_fleet.GRIDS):
        got = bench_fleet.fixture_run(case, dev)
        errs = bench_fleet.fixture_errors(got, fleet_data, case)
        phase(f"fixture:fleet_{case}", ticks=bench_fleet.FIXTURE_TICKS,
              alive="equal",
              **{k: f"{e:.3g}/{lim:.3g}" for k, (e, lim) in errs.items()})
        bad = {k: e for k, (e, lim) in errs.items() if not e <= lim}
        if bad:
            raise RuntimeError(f"fixture fleet {case} mismatch: {bad}")


def check_path_vs_single(dev, path: str):
    """35. The B=64 fleet of `path` (16 scenarios a robot) against each
    robot run alone at B=16 with one-robot parameters."""
    from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
    from quadruped_tpu_torch.benchmarks import fleet_paths as bench_paths

    reset_counts()
    f = bench_paths.build(path, GRID_CHECK, dev)
    f, tr = bench_paths.run(f, FLEET_CHECK_TICKS)
    torch.cuda.synchronize()
    check_launches = path_launches(
        f"fleet:{path}:vs_single", int(bench_paths.boots_mpc(path))
        + bench_paths.mpc_solves(f, FLEET_CHECK_TICKS))
    errs = {"height": 0.0, "q": 0.0}
    for robot in bench_fleet.ROBOTS:
        a = bench_paths.alone(f, robot, dev)
        a, tra = bench_paths.run(a, FLEET_CHECK_TICKS)
        rows = torch.as_tensor(a.rows, device=dev)
        for k in errs:
            errs[k] = max(errs[k],
                          (tr[k][rows] - tra[k]).abs().max().item())
    sim = ("srb" if isinstance(f.loop, bench_paths.RolloutLoop)
           else "whole_body")
    hold(f"fleet:{path}:vs_single:B{GRID_CHECK}", errs,
         dict.fromkeys(errs, 0.0), FLEET_CHECK_TOL[sim], sim=sim,
         ticks=FLEET_CHECK_TICKS, fleet_kernel_launches=check_launches)


def check_tasks() -> dict:
    """{name: function of the device} of every check phase."""
    import functools

    from quadruped_tpu_torch.benchmarks import fleet_paths as bench_paths

    tasks = {"fixture": check_fixture,
             "fixture:velocity": functools.partial(check_modes_fixture,
                                                   which="velocity"),
             "fixture:position": functools.partial(check_modes_fixture,
                                                   which="position"),
             "whole_body:cross_srb": check_cross_srb,
             "fixture:wbc": check_wbc_fixture,
             "fixture:whole_body": check_whole_body_fixture,
             "fixture:walk": check_walk_windows,
             "fixture:runner": check_runner_windows,
             "fleet:vs_single": check_fleet_vs_single,
             "fixture:fleet": check_fleet_fixture}
    for path in bench_paths.PATHS:
        tasks[f"fleet:{path}:vs_single"] = functools.partial(
            check_path_vs_single, path=path)
    return tasks


def split_checks(names, n: int) -> list:
    """`names` in n groups of about equal CHECK_SECONDS, the longest check
    first into the lightest group; group 0 runs in this process."""
    groups = [[] for _ in range(n)]
    load = [0.0] * n
    for name in sorted(names, key=lambda k: -CHECK_SECONDS[k]):
        g = load.index(min(load))
        groups[g].append(name)
        load[g] += CHECK_SECONDS[name]
    return groups


def run_checks(dev, names):
    tasks = check_tasks()
    for name in names:
        tasks[name](dev)


def check_block(dev) -> dict:
    """Every check phase, over CHECK_PROCESSES processes on the card at
    once; the workers' lines are printed when they end. Raises if a check
    fails in any process; no worker outlives the call."""
    import subprocess

    groups = split_checks(list(check_tasks()), CHECK_PROCESSES)
    work = ROOT / "quadruped_tpu_torch" / "_build" / "checks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = []
    t0 = time.perf_counter()
    try:
        for i, names in enumerate(groups[1:], 1):
            out = open(work / f"worker{i}.out", "w")
            err = open(work / f"worker{i}.err", "w")
            procs.append((i, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--checks",
                 ",".join(names)], cwd=ROOT, stdout=out, stderr=err)))
            out.close()
            err.close()
        run_checks(dev, groups[0])
        failed = []
        for i, proc in procs:
            rc = proc.wait(timeout=CHECK_TIMEOUT_S)
            print((work / f"worker{i}.out").read_text(), end="", flush=True)
            if rc != 0:
                failed.append(f"worker {i} ({','.join(groups[i])}) exit "
                              f"{rc}:\n"
                              + (work / f"worker{i}.err").read_text()[-4000:])
        if failed:
            raise RuntimeError("check phases failed:\n" + "\n".join(failed))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(work, ignore_errors=True)
    return dict(processes=CHECK_PROCESSES,
                groups=json.dumps(groups),
                wall_s=time.perf_counter() - t0)


def main_checks(names) -> int:
    """A check worker: the named checks on the card, one line each."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_checks(torch.device("cuda:0"), names)
    return 0


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
    from quadruped_tpu_torch.solvers import condense, problems
    from quadruped_tpu_torch.solvers.problems import bench_problems
    from quadruped_tpu_torch.core import se3 as se3_mod
    from quadruped_tpu_torch.dynamics import srb as srb_mod
    from quadruped_tpu_torch.benchmarks import wbc as bench_wbc
    from quadruped_tpu_torch.benchmarks import walk as bench_walk
    from quadruped_tpu_torch.benchmarks import whole_body as bench_wb
    from quadruped_tpu_torch.benchmarks import transition as bench_trans
    from quadruped_tpu_torch.benchmarks import runner as bench_runner
    from quadruped_tpu_torch.gait.walk import SubLegState
    from quadruped_tpu_torch.planner import pose_planner
    from quadruped_tpu_torch.control import wbc as wbc_mod
    from quadruped_tpu_torch.utils import card, checkpoint, cuda_build, tree
    from quadruped_tpu_torch.utils.trace import (compare_traces, load_trace,
                                                 save_trace)
    from quadruped_tpu_torch.benchmarks import fleet as bench_fleet
    from quadruped_tpu_torch.benchmarks import fleet_paths as bench_paths
    from quadruped_tpu_torch.robots import named_params
    from quadruped_tpu_torch.gait import named_gait

    wrappers = kernel_wrappers()

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
    rng = np.random.default_rng(0)
    mode_cmds = {
        "velocity": (ControlMode.VELOCITY,
                     (0.1 + 0.3 * rng.random(BATCH)).astype(np.float32)),
        "position": (ControlMode.POSITION,
                     (0.1 * rng.random(BATCH)).astype(np.float32))}
    for name, (mode, vx) in mode_cmds.items():
        config = mode_config(mode, dev)
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
        return all(torch.isfinite(v).all().item()
                   for o in objs for _, v in tree.leaves(o)
                   if isinstance(v, torch.Tensor) and v.is_floating_point())

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

    # 20. The heterogeneous fleet: the twin of the JAX example's sweep at
    # B=2048 (the 16-scenario grid tiled 128 times).
    fleet = bench_fleet.build(FLEET_REPEATS, dev)
    bench_fleet.run(fleet, 2)                                     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fres = bench_fleet.run(fleet, FLEET_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fleet_solves = bench_fleet.mpc_solves(fleet.config, FLEET_TICKS)
    launches_fleet = counts_after("fleet", "fused_admm", fleet_solves)
    if not finite(fres):
        raise RuntimeError("fleet: non-finite state")
    robots = bench_fleet.per_robot(fleet, fres)
    spread = bench_fleet.copy_spread(fleet, fres)
    alive_rows = fres.alive > 0.5
    final_h = fres.base_height_trace[:, -1]
    dh_cmd = (final_h - fleet.cmd.body_height)[alive_rows].abs().max().item()
    dh_own = {r: (final_h - fleet.params.body_height)[
        alive_rows & torch.tensor([x == r for x in fleet.robots],
                                  device=dev)].abs().max().item()
        for r in bench_fleet.ROBOTS}
    dh_bad = {r: d for r, d in dh_own.items()
              if r in FLEET_JAX_TEST_ROBOTS and not d <= FLEET_HEIGHT_TOL}
    fleet_ms = 1e3 * wall / FLEET_TICKS
    carry = rollout_mod.rollout_init(fleet.config, fleet.params, FLEET_BATCH)
    prof = device_profile(lambda: rollout_mod.rollout_segment(
        fleet.config, fleet.params, fleet.cmd, carry, CYCLE_TICKS),
        CYCLE_TICKS, fleet_ms)
    phase(f"fleet:B{FLEET_BATCH}", ticks=FLEET_TICKS,
          kernel_launches=launches_fleet, mpc_solves=fleet_solves,
          wall_s=wall, ms_per_tick=fleet_ms,
          ticks_per_s=FLEET_BATCH * FLEET_TICKS / wall,
          robot_seconds_per_wall_second=FLEET_BATCH * FLEET_TICKS
          * bench_fleet.DT / wall, **prof,
          alive=json.dumps({k: r["alive"] for k, r in robots.items()}),
          final_vx=json.dumps({k: round(r["final_vx"], 4)
                               for k, r in robots.items()}),
          final_height=json.dumps({k: round(r["final_height"], 4)
                                   for k, r in robots.items()}),
          max_abs_final_height_minus_commanded=dh_cmd,
          max_abs_final_height_minus_own_body_height=json.dumps(
              {k: round(v, 4) for k, v in dh_own.items()}),
          max_copy_difference_m=spread, card=json.dumps(smi))
    if (min(r["alive"] for r in robots.values()) < 0.99
            or not dh_cmd <= FLEET_HEIGHT_TOL or dh_bad
            or not spread <= FLEET_COPY_TOL):
        raise RuntimeError(f"fleet: alive {robots}, final heights off the "
                           f"command by {dh_cmd} m and off their own body "
                           f"height by {dh_own} (limit {FLEET_HEIGHT_TOL}), "
                           f"copies {spread} m apart (limit "
                           f"{FLEET_COPY_TOL})")

    # 21. K1 on a batch captured from the mixed fleet (per-row force caps
    # and mu) against its plain version, and its time beside the same
    # batch shape captured from an A1-only fleet.
    def capture_warm_solve(f):
        """(ConeQP, solve kwargs) of the first warm MPC solve of `f`."""
        got = []
        solve = cone_qp.solve
        cone_qp.solve = lambda prob, **kw: got.append((prob, kw)) or \
            solve(prob, **kw)
        try:
            c = rollout_mod.rollout_init(f.config, f.params, FLEET_BATCH)
            rollout_mod.rollout_segment(f.config, f.params, f.cmd, c,
                                        CYCLE_TICKS + 1)
        finally:
            cone_qp.solve = solve
        return got[-1]

    a1_fleet = bench_fleet.build(FLEET_REPEATS * len(bench_fleet.ROBOTS),
                                 dev, robots=("a1",))
    k1_fleet = {}
    for name, f in (("mixed", fleet), ("a1_only", a1_fleet)):
        prob, kw = capture_warm_solve(f)
        inp = cone_qp.admm_inputs(prob, rho=kw["rho"], x0=kw["x0"],
                                  y0=kw["y0"])
        k_kw = dict(iters=kw["iters"], sigma=cone_qp.SIGMA,
                    alpha=kw["alpha"], accel_restart=kw["accel_restart"])
        k1_fleet[name] = (prob, kw, inp, k_kw)
    prob, kw, inp, k_kw = k1_fleet["mixed"]
    args = inp[:8]
    dx, dy = admm_vs_plain("fleet mixed", args, k_kw)
    rng = np.random.default_rng(0)
    mu_rows = torch.as_tensor(rng.uniform(0.3, 0.9, FLEET_BATCH)
                              .astype(np.float32), device=dev)
    mu_inp = cone_qp.admm_inputs(dataclasses.replace(prob, mu=mu_rows),
                                 rho=kw["rho"], x0=kw["x0"], y0=kw["y0"])
    dx_mu, dy_mu = admm_vs_plain("fleet per-row mu", mu_inp[:8], k_kw)
    # Timed in turns (mixed, A1 only, A1 only, mixed): the two batches'
    # difference apart from the order of the timings.
    a1_args = k1_fleet["a1_only"][2][:8]
    turns = [card.time_ms(lambda a=a: fused_admm.fused_admm(*a, **k_kw), 20)
             for a in (args, a1_args, a1_args, args)]
    fleet_k1_ms = (turns[0] + turns[3]) / 2
    a1_k1_ms = (turns[1] + turns[2]) / 2
    fleet_plain_ms = card.time_ms(
        lambda: fused_admm.fused_admm_reference(*args, **k_kw), 3)
    nbytes, ops = admm_work(FLEET_BATCH, args[1].shape[1], k_kw["iters"])
    fleet_bound = bound(nbytes, ops)
    caps = prob.fz_hi.amax(1)
    phase("fleet:k1_vs_plain", batch=FLEET_BATCH, n=args[1].shape[1],
          iters=k_kw["iters"],
          force_caps_N=json.dumps(sorted({round(v, 3) for v in
                                          caps.tolist()})),
          mu=json.dumps(sorted(set(prob.mu.tolist()))), max_abs_dx=dx,
          max_abs_dy=dy, per_row_mu_max_abs_dx=dx_mu,
          per_row_mu_max_abs_dy=dy_mu, tol=admm_tol,
          kernel_ms_mixed=fleet_k1_ms, kernel_ms_a1_only=a1_k1_ms,
          kernel_ms_turns=json.dumps([round(t, 5) for t in turns]),
          plain_ms=fleet_plain_ms, bound_ms=fleet_bound[0],
          bound_by=fleet_bound[1], share_of_bound=fleet_bound[0]
          / fleet_k1_ms, card=json.dumps(smi))

    # 25. The seeded route of the bench (minv_reuse) against the cold route
    # at B=8192: one counted update each, the inverse stage of each timed
    # alone, then their rates.
    minv_launches, minv_k1 = 0, {}
    for horizon in (10, 16):
        fn_c, args_c, cfg = bench.build_bench(BENCH_BATCH, "loop", horizon,
                                              device=dev)
        fn_s, args_s, _ = bench.build_bench(BENCH_BATCH, "loop", horizon,
                                            device=dev, minv_reuse=True)
        torch.cuda.synchronize()
        where = f"minv_reuse update H={horizon}"
        reset_counts()
        x_s, y_s, carry_out = fn_s(*args_s)
        torch.cuda.synchronize()
        launches = counts_after(where, "fused_admm", 1)
        minv_launches += launches
        reset_counts()
        x_c, _ = fn_c(*args_c)
        torch.cuda.synchronize()
        counts_after(f"cold update H={horizon}", "fused_admm", 1)
        if not (torch.isfinite(x_s).all() and torch.isfinite(y_s).all()
                and torch.isfinite(carry_out.m_inv).all()):
            raise RuntimeError(f"{where}: not finite")
        dforce = (x_s - x_c)[:, :12].abs().max().item()
        # The inverse stage alone on this update's M, cold and seeded, and
        # the seeded route's Woodbury capacitance scan (40 rank-1 steps).
        carry = args_s[6]
        prob = bench.cadence_problem(cfg, params, *args_s[:4])
        m_mat, inp = cone_qp.admm_operands(prob, cone_qp.RHO_CONE,
                                           cone_qp.SIGMA, *args_s[4:6])
        # The JAX algorithm (no rescue) beside the bench's (with it): how
        # many polishes diverged, and how many the rescue replaced.
        seed_args = (m_mat, carry, inp.d_t, inp.gamma, inp.pinned,
                     cone_qp.RHO_CONE)
        rescue = dict(rescue_iters=cone_qp.NS_ITERS)
        x_ref = cone_qp.seeded_inverse(*seed_args)
        diverged = int((~(cone_qp.probe_residual(m_mat, x_ref)
                          <= cone_qp.RESCUE_RESID)).sum())
        rescued_before = cone_qp.seeded_inverse.rescued
        x_seed = cone_qp.seeded_inverse(*seed_args, **rescue)
        rescued = cone_qp.seeded_inverse.rescued - rescued_before
        x_cold = cone_qp.newton_schulz_inverse(m_mat, cone_qp.NS_ITERS, 1)
        eye = torch.eye(m_mat.shape[-1], device=dev)
        res_seed, res_cold = ((eye - torch.bmm(m_mat, inv)).abs().max().item()
                              for inv in (x_seed, x_cold))
        s_cap = carry.m_inv[:, 2::3, 2::3].contiguous()
        c_cap = 99.0 * cone_qp.RHO_CONE * (inp.pinned - carry.pinned)
        ms_cold = card.time_ms(lambda: cone_qp.newton_schulz_inverse(
            m_mat, cone_qp.NS_ITERS, 1), 10)
        ms_seed = card.time_ms(lambda: cone_qp.seeded_inverse(
            *seed_args, **rescue), 10)
        ms_seed_ref = card.time_ms(
            lambda: cone_qp.seeded_inverse(*seed_args), 10)
        ms_cap = card.time_ms(lambda: cone_qp._capacitance_inverse(
            s_cap, c_cap), 10)
        # K1 on the seeded update's operands against its plain version.
        k1_ops = (x_seed, *inp[1:8])
        k1_kw = dict(iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                     accel_restart=cfg.qp_accel_restart, sigma=cone_qp.SIGMA)
        k1_err = max(admm_vs_plain(where, k1_ops, k1_kw))
        max_err = max(max_err, k1_err)
        k1_ms = card.time_ms(lambda: fused_admm.fused_admm(*k1_ops, **k1_kw),
                             10)
        k1_plain_ms = card.time_ms(
            lambda: fused_admm.fused_admm_reference(*k1_ops, **k1_kw), 3)
        k1_bound = bound(*admm_work(BENCH_BATCH, x_s.shape[1],
                                    cfg.qp_iters))
        minv_k1[horizon] = (k1_ms, k1_plain_ms, k1_bound, k1_err)
        rates = {}
        for name, (fn, args) in (("cold", (fn_c, args_c)),
                                 ("seeded", (fn_s, args_s))):
            r = bench.update_rates(fn, args, BENCH_BATCH, reps=10, runs=3)
            rates[name] = (r[len(r) // 2], r[0], r[-1])
        phase(f"minv_reuse:update:h{horizon}", batch=BENCH_BATCH,
              n=x_s.shape[1], kernel_launches=launches,
              max_first_step_dforce_mg=dforce / MG, tol=MINV_TOL[horizon],
              flips=int((inp.pinned != carry.pinned).sum().item()),
              inverse_ms_cold=ms_cold, inverse_ms_seeded=ms_seed,
              inverse_ms_seeded_no_rescue=ms_seed_ref,
              capacitance_ms=ms_cap, capacitance_share=ms_cap / ms_seed,
              diverged_without_rescue=diverged, rescued=rescued,
              residual_seeded=res_seed, residual_cold=res_cold,
              kernel_ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound[0],
              kernel_max_abs_err=k1_err, kernel_tol=admm_tol,
              **{f"solves_per_s_{k}": f"{v[0]:.1f} [{v[1]:.1f}, {v[2]:.1f}]"
                 for k, v in rates.items()},
              card=json.dumps(smi))
        if not (dforce <= MINV_TOL[horizon] * MG
                and rescued <= RESCUE_MAX_SHARE * BENCH_BATCH):
            raise RuntimeError(f"{where}: forces {dforce / MG:.4f} m*g off "
                               f"the cold update, {rescued} rescued")
        del fn_c, fn_s, args_c, args_s, carry, carry_out, m_mat, inp
        del x_seed, x_ref, x_cold, s_cap, prob

    # 26. A carried chain at B=2048: 40 cadence solves, seeded (with the
    # rescue) and cold, each against a 400-iteration relaxed solve of the
    # same problem; beside them a control chain, cold with two float32
    # polish steps (a better inverse than the cold route's).
    chain_cfg = mpc_mod.MpcConfig()
    warm_kw = dict(iters=chain_cfg.qp_iters, alpha=chain_cfg.qp_alpha,
                   accel_restart=chain_cfg.qp_accel_restart)
    boot_kw = dict(iters=chain_cfg.qp_cold_iters,
                   alpha=chain_cfg.qp_cold_alpha)
    reset_counts()
    rescued_before = cone_qp.seeded_inverse.rescued
    mean_excess, worst_excess, flips = [], [], 0
    per_scenario = {"seeded": [], "control": []}
    starts = carry = pins = None
    for k in range(CHAIN_STEPS):
        prob, _ = bench_problems(CHAIN_BATCH, horizon=10,
                                 t=k * bench.CADENCE_S, device=dev)
        oracle = cone_qp.solve(prob, **boot_kw)
        if k == 0:
            sol, carry = cone_qp.solve(prob, **boot_kw,
                                       return_inv_carry=True)
            sols = {"seeded": sol, "cold": oracle, "control": oracle}
        else:
            sols = {"cold": cone_qp.solve(prob, **warm_kw, **starts["cold"]),
                    "control": cone_qp.solve(prob, **warm_kw,
                                             **starts["control"],
                                             ns_f32_polish=2)}
            sols["seeded"], carry = cone_qp.solve(
                prob, **warm_kw, **starts["seeded"], inv_carry=carry,
                seed_rescue=True, return_inv_carry=True)
        flips += 0 if pins is None else int((carry.pinned != pins).sum())
        pins = carry.pinned
        starts = {name: dict(x0=sol.x, y0=sol.y)
                  for name, sol in sols.items()}
        if not all(bool(torch.isfinite(sol.x).all()
                        and torch.isfinite(sol.y).all())
                   for sol in sols.values()):
            raise RuntimeError(f"minv_reuse chain: step {k} not finite")
        err = {name: (sol.x - oracle.x)[:, :12].abs().amax(dim=1) / MG
               for name, sol in sols.items()}
        mean_excess.append(
            (err["seeded"].mean() - err["cold"].mean()).item())
        worst_excess.append(
            (err["seeded"].max() - err["cold"].max()).item())
        for name in per_scenario:
            per_scenario[name].append(err[name] - err["cold"])
    solves = 4 * CHAIN_STEPS - 2      # step 0: the boot and its oracle
    counts_after("minv_reuse chain", "fused_admm", solves)
    quant = torch.tensor([0.5, 0.99, 1.0], device=dev)
    spread = {name: [round(v, 5) for v in torch.quantile(
        torch.cat(d), quant).tolist()] for name, d in per_scenario.items()}
    rescued = cone_qp.seeded_inverse.rescued - rescued_before
    phase(f"minv_reuse:chain:B{CHAIN_BATCH}", steps=CHAIN_STEPS,
          pin_flips=flips, rescued=rescued,
          max_mean_excess_mg=max(mean_excess), tol=CHAIN_EXCESS,
          max_worst_excess_mg=max(worst_excess),
          per_scenario_excess_p50_p99_max=json.dumps(spread["seeded"]),
          control_per_scenario_excess_p50_p99_max=json.dumps(
              spread["control"]), kernel_launches=solves)
    if not (max(mean_excess) <= CHAIN_EXCESS and flips > 0 and rescued
            <= RESCUE_MAX_SHARE * CHAIN_BATCH * (CHAIN_STEPS - 1)):
        raise RuntimeError(f"minv_reuse chain: the seeded path's mean error "
                           f"exceeds the cold path's by "
                           f"{max(mean_excess):.4f} m*g ({flips} pin flips, "
                           f"{rescued} rescued)")

    # 27. K1 from a carried z0 (the bf16 head's iterate) against its plain
    # version, timed beside K1 without z0; then the bf16-head solve on the
    # card against the same solve on the CPU.
    prob, _ = bench_problems(BATCH, horizon=10, device=dev)
    inp = cone_qp.admm_inputs(prob)
    x_h, z_h, y_h = cone_qp.bf16_head(inp, 4, cone_qp.SIGMA, cone_qp.ALPHA)
    z0_args = (*inp[:6], x_h, y_h)
    z0_kw = dict(iters=20, sigma=cone_qp.SIGMA, alpha=cone_qp.ALPHA)
    xk, yk = fused_admm.fused_admm(*z0_args, **z0_kw, z0=z_h)
    xr, yr = fused_admm.fused_admm_reference(*z0_args, **z0_kw, z0=z_h)
    torch.cuda.synchronize()
    if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
        raise RuntimeError("fused_admm with z0: not finite")
    torch.testing.assert_close(xk, xr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(yk, yr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    z0_err = max((xk - xr).abs().max().item(), (yk - yr).abs().max().item())
    z0_ms = {}
    for name in ("z0", "none", "none", "z0"):   # in turns
        z = z_h if name == "z0" else None
        z0_ms.setdefault(name, []).append(card.time_ms(
            lambda: fused_admm.fused_admm(*z0_args, **z0_kw, z0=z), 20))
    z0_ms = {k: min(v) for k, v in z0_ms.items()}
    z0_plain_ms = card.time_ms(lambda: fused_admm.fused_admm_reference(
        *z0_args, **z0_kw, z0=z_h), 3)
    z0_bound = bound(*admm_work(BATCH, inp.q.shape[1], z0_kw["iters"]))
    prob_b, _ = bench_problems(BF16_BATCH, horizon=10, device=dev)
    prob_cpu, _ = bench_problems(BF16_BATCH, horizon=10, device="cpu")
    bf_kw = dict(iters=24, bf16_iters=4, ns_f32_polish=2)
    reset_counts()
    sol_k = cone_qp.solve(prob_b, **bf_kw)
    torch.cuda.synchronize()
    counts_after("bf16 head solve", "fused_admm", 1)
    sol_p = cone_qp.solve(prob_cpu, **bf_kw)
    bf_dx = (sol_k.x.cpu() - sol_p.x).abs()
    bf_first = bf_dx[:, :12].max().item() / MG
    bf_all = bf_dx.max().item() / MG
    bf_dy = (sol_k.y.cpu() - sol_p.y).abs()
    bf_y = (bf_dy - 1e-3 * sol_p.y.abs()).max().item()
    phase("k1:z0", batch=BATCH, n=inp.q.shape[1], iters=z0_kw["iters"],
          max_abs_err=z0_err, tol=admm_tol, kernel_ms_z0=z0_ms["z0"],
          kernel_ms_no_z0=z0_ms["none"], plain_ms_z0=z0_plain_ms,
          bound_ms=z0_bound[0], bound_by=z0_bound[1],
          share_of_bound=z0_bound[0] / z0_ms["z0"],
          bf16_solve_first_step_mg=bf_first, bf16_solve_max_mg=bf_all,
          bf16_solve_dual_excess=bf_y,
          bf16_tol="first step 0.005 m*g, all 0.03 m*g, y 1e-3 + 1e-3 |y|",
          card=json.dumps(smi))
    if not (bf_first <= 0.005 and bf_all <= 0.03 and bf_y <= 1e-3):
        raise RuntimeError("bf16-head solve on the card differs from the "
                           "CPU's")

    # 28. Dense against structured condensation on the card, B=2048.
    rpy, feet, x0_s = (torch.as_tensor(a, device=dev) for a in
                       problems.bench_states(BATCH, 0.0,
                                             np.random.default_rng(0)))
    x_des = x0_s[:, None, :].repeat(1, 10, 1)
    x_des[..., 9] = 0.4
    a_ct, b_ct = srb_mod.srb_continuous(
        se3_mod.rpy_to_rotmat(rpy), params.total_inertia, params.total_mass,
        feet)
    ad, bd = srb_mod.srb_discretize(a_ct, b_ct, problems.DT_MPC)
    w = torch.tensor(problems.STATE_WEIGHTS, dtype=torch.float32, device=dev)
    p_d, q_d = condense.condense_cost(ad, bd, x0_s, x_des, w,
                                      problems.FORCE_WEIGHT, 10)
    p_s, q_s = condense.condense_cost_structured(
        a_ct, bd, ad, x0_s, x_des, w, problems.FORCE_WEIGHT, 10,
        problems.DT_MPC)
    rel_p = ((p_d - p_s).abs().max() / p_s.abs().max()).item()
    rel_q = ((q_d - q_s).abs().max() / q_s.abs().max()).item()
    phase(f"condense:dense:B{BATCH}", rel_err_p=rel_p, rel_err_q=rel_q,
          tol=DENSE_REL)
    if not (rel_p <= DENSE_REL and rel_q <= DENSE_REL):
        raise RuntimeError("dense condensation differs from the structured "
                           "one")

    # 29-35. The fleet on every other path (benchmarks/fleet_paths.py):
    # the four robots tiled to each path's batch, each path's own
    # configuration; then K1 on the whole-body fleet's mixed caps, and the
    # B=64 fleet of each path against each robot alone at B=16.
    gc.collect()
    gc.freeze()

    def fleet_finite(f) -> bool:
        return all(bool(torch.isfinite(t).all())
                   for t in bench_paths.state_tensors(f))

    fleet_k1 = {}
    for path, batch, ticks in FLEET_PATHS:
        bench_paths.run(bench_paths.build(path, GRID_CHECK, dev), 2)
        torch.cuda.synchronize()
        reset_counts()
        f = bench_paths.build(path, batch, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, tr = bench_paths.run(f, ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solves = bench_paths.mpc_solves(f, ticks)
        booted = int(bench_paths.boots_mpc(path))
        launches = path_launches(f"fleet:{path}", booted + solves)
        if not (fleet_finite(f) and torch.isfinite(tr["height"]).all()):
            raise RuntimeError(f"fleet:{path}: non-finite state")
        tick_ms = 1e3 * wall / ticks
        cycle = (CYCLE_TICKS if bench_paths.mpc_solves(f, CYCLE_TICKS)
                 else 1)
        holder = [f]

        def profiled(n=cycle):
            holder[0], _ = bench_paths.run(holder[0], n)

        prof = device_profile(profiled, cycle, tick_ms)
        alive = bench_paths.per_robot(f, bench_paths.alive(f))
        height = bench_paths.per_robot(f, bench_paths.base_height(f))
        # Each robot's alive share against the same robot alone on the
        # same scenarios, where the fleet's share leaves room below 1.
        alone_alive = {}
        for robot, share in alive.items():
            if share < 0.99:
                a, _ = bench_paths.run(bench_paths.alone(f, robot, dev),
                                       ticks)
                alone_alive[robot] = bench_paths.alive(a).mean().item()
        phase(f"fleet:{path}:B{batch}", ticks=ticks, wall_s=wall,
              ms_per_tick=tick_ms, ticks_per_s=batch * ticks / wall,
              robot_seconds_per_wall_second=batch * ticks * 0.002 / wall,
              kernel_launches=launches, mpc_solves=booted + solves,
              alive=json.dumps({k: round(v, 4) for k, v in alive.items()}),
              alone_alive=json.dumps(alone_alive),
              final_height=json.dumps({k: round(v, 4)
                                       for k, v in height.items()}),
              **prof, card=json.dumps(smi))
        bad = {r: (alive[r], v) for r, v in alone_alive.items()
               if alive[r] < v - 0.01}
        if bad:
            raise RuntimeError(f"fleet:{path}: alive share below the robot "
                               f"alone: {bad}")
        fleet_k1[path] = launches
        del f, holder

    # K1 on the warm MPC batch of the whole-body fleet (n = 120, per-row
    # force caps of four robots) against its plain version, timed in turns
    # with the same shape from the A1 alone.
    def capture_solve(robots):
        """(ConeQP, K1 operands, K1 kwargs) of the first warm MPC solve of
        the whole-body loop of the grid of `robots` at WB_FLEET_BATCH."""
        got = []
        solve = cone_qp.solve
        cone_qp.solve = lambda prob, **kw: got.append((prob, kw)) or \
            solve(prob, **kw)
        try:
            bench_paths.run(bench_paths.build("wholebody", WB_FLEET_BATCH,
                                              dev, robots), CYCLE_TICKS + 1)
        finally:
            cone_qp.solve = solve
        prob, kw = got[-1]
        inp = cone_qp.admm_inputs(prob, rho=kw["rho"], x0=kw["x0"],
                                  y0=kw["y0"])
        return prob, inp[:8], dict(iters=kw["iters"], sigma=cone_qp.SIGMA,
                                   alpha=kw["alpha"],
                                   accel_restart=kw["accel_restart"])

    prob_wb, args_wb, kw_wb = capture_solve(bench_fleet.ROBOTS)
    _, args_a1, _ = capture_solve(("a1",))
    dx_wb, dy_wb = admm_vs_plain("whole-body fleet mixed", args_wb, kw_wb)
    max_err = max(max_err, dx_wb, dy_wb)
    turns_wb = [card.time_ms(lambda a=a: fused_admm.fused_admm(*a, **kw_wb),
                             20)
                for a in (args_wb, args_a1, args_a1, args_wb)]
    wb_k1_ms = (turns_wb[0] + turns_wb[3]) / 2
    wb_a1_ms = (turns_wb[1] + turns_wb[2]) / 2
    wb_plain_ms = card.time_ms(
        lambda: fused_admm.fused_admm_reference(*args_wb, **kw_wb), 3)
    wb_bound = bound(*admm_work(WB_FLEET_BATCH, args_wb[1].shape[1],
                                kw_wb["iters"]))
    phase("fleet:wholebody:k1_vs_plain", batch=WB_FLEET_BATCH,
          n=args_wb[1].shape[1], iters=kw_wb["iters"],
          force_caps_N=json.dumps(sorted({round(v, 3) for v in
                                          prob_wb.fz_hi.amax(1).tolist()})),
          max_abs_dx=dx_wb, max_abs_dy=dy_wb, tol=admm_tol,
          kernel_ms_mixed=wb_k1_ms, kernel_ms_a1_only=wb_a1_ms,
          kernel_ms_turns=json.dumps([round(t, 5) for t in turns_wb]),
          plain_ms=wb_plain_ms, bound_ms=wb_bound[0], bound_by=wb_bound[1],
          share_of_bound=wb_bound[0] / wb_k1_ms,
          launches_wbc=fleet_k1["wbc"],
          launches_wholebody=fleet_k1["wholebody"], card=json.dumps(smi))

    # The check phases (4, 9, the cross-simulator check of 11, 12, the walk
    # windows of 15, 19, 22-24, the per-path fleets of 35), all at once.
    phase("checks", **check_block(dev))

    # 36-39. The host bridge, the hil tick, distributed/.
    late = phases_bridge_hil_distributed(dev, smi)

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
        "launches_fleet": launches_fleet,
        "ms_fleet_mixed": fleet_k1_ms, "ms_fleet_a1_only": a1_k1_ms,
        "plain_ms_fleet": fleet_plain_ms, "bound_ms_fleet": fleet_bound[0],
        "max_abs_err_fleet": max(dx, dy, dx_mu, dy_mu),
        "launches_fleet_wbc": fleet_k1["wbc"],
        "launches_fleet_wholebody": fleet_k1["wholebody"],
        "launches_fleet_runner": fleet_k1["runner"],
        "ms_fleet_wholebody_mixed": wb_k1_ms,
        "ms_fleet_wholebody_a1_only": wb_a1_ms,
        "plain_ms_fleet_wholebody": wb_plain_ms,
        "bound_ms_fleet_wholebody": wb_bound[0],
        "max_abs_err_fleet_wholebody": max(dx_wb, dy_wb),
        "ms_boot_n192": timing["boot_n192"][0],
        "plain_ms_boot_n192": timing["boot_n192"][1],
        "bound_ms_boot_n192": timing["boot_n192"][2],
        "bound_by_boot_n192": timing["boot_n192"][3],
        "max_abs_dforce_boot_n192_N": timing["boot_n192"][4],
        "ms_bench": loop_bench[0], "plain_ms_bench": loop_bench[1],
        "bound_ms_bench": loop_bench[2]["bound_ms"],
        "launches_minv_reuse": minv_launches,
        "ms_minv_reuse": minv_k1[10][0], "plain_ms_minv_reuse": minv_k1[10][1],
        "bound_ms_minv_reuse": minv_k1[10][2][0],
        "max_abs_err_minv_reuse": minv_k1[10][3],
        "ms_z0": z0_ms["z0"], "ms_no_z0": z0_ms["none"],
        "plain_ms_z0": z0_plain_ms, "bound_ms_z0": z0_bound[0],
        "max_abs_err_z0": z0_err,
        **late,
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
    if sys.argv[1:2] == ["--checks"]:
        sys.exit(main_checks(sys.argv[2].split(",")))
    sys.exit(main())
