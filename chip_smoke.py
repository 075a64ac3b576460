"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  0. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 off for every float32 product;
  1. build: the fused ADMM kernel with nvcc from quadruped_tpu_torch/csrc;
  2. kernel vs plain: the kernel against its plain torch version on B=2048
     H=10 MPC problems (the JAX solver benchmark's state and trot-table
     distribution), in the 400-iteration relaxed boot scheme and the
     24-iteration warm Fast-ADMM scheme, with times of both;
  3. the slice: `rollout_cadenced` for B=2048 A1 scenarios at the production
     MPC configuration, 18 MPC periods, commands vx ~ U(0.2, 0.8),
     wz ~ N(0, 0.2); the kernel must be launched once per solve (1 boot +
     18 periods), every state finite, and at least 99% of scenarios alive;
  4. fixture: the 4-scenario production-config rollout against the JAX
     package's output checked in at tests/data/rollout_cadenced_a1_h10.npz.
The last two lines are a JSON object describing the kernels and the
device JSON object. There is no CPU path: without a CUDA device the script
fails before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "rollout_cadenced_a1_h10.npz"
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


def phase(name: str, **values):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "runs only on the card")
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.robots import a1_params
    from quadruped_tpu_torch.sim.rollout_cadenced import rollout_cadenced
    from quadruped_tpu_torch.solvers import cone_qp, fused_admm
    from quadruped_tpu_torch.solvers.problems import bench_problems

    # 0. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase("env", card=json.dumps(smi), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          tf32=torch.backends.cuda.matmul.allow_tf32)

    # 1. Build.
    t0 = time.perf_counter()
    log = fused_admm.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=f"{time.perf_counter() - t0:.3f}",
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
        xk, yk = fused_admm.fused_admm(*args, **kw)
        xr, yr = fused_admm.fused_admm_reference(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(xk).all() and torch.isfinite(yk).all()):
            raise RuntimeError(f"kernel output not finite ({name})")
        torch.testing.assert_close(xk, xr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        torch.testing.assert_close(yk, yr, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        dx = (xk - xr).abs().max().item()
        dy = (yk - yr).abs().max().item()
        max_err = max(max_err, dx, dy)
        ms = time_ms(lambda: fused_admm.fused_admm(*args, **kw), 20)
        plain_ms = time_ms(
            lambda: fused_admm.fused_admm_reference(*args, **kw), 3)
        timing[name] = (ms, plain_ms)
        phase(f"kernel_vs_plain:{name}", batch=BATCH, n=args[1].shape[1],
              iters=kw["iters"], max_abs_dx=dx, max_abs_dy=dy,
              tol=f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}", kernel_ms=ms,
              plain_ms=plain_ms)

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
    fused_admm.fused_admm.launches = 0
    t0 = time.perf_counter()
    res = rollout_cadenced(config, params, cmd, N_PERIODS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_admm.fused_admm.launches
    if launches != 1 + N_PERIODS:
        raise RuntimeError(f"fused_admm launched {launches} times, expected "
                           f"{1 + N_PERIODS} (1 boot + {N_PERIODS} periods)")
    tensors = [getattr(res.sim, f.name) for f in
               res.sim.__dataclass_fields__.values()]
    tensors += [res.base_height_trace, res.vel_trace]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError("non-finite state in the rollout")
    alive = res.alive.mean().item()
    h = res.sim.position[:, 2]
    ticks = BATCH * N_PERIODS * config.mpc.ticks_per_solve
    phase("slice", batch=BATCH, periods=N_PERIODS, kernel_launches=launches,
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
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in FIXTURE_TOL}
    bad = {k: e for k, e in errs.items() if not e <= FIXTURE_TOL[k]}
    phase("fixture", **{k: f"{e:.3g}/{FIXTURE_TOL[k]:g}"
                        for k, e in errs.items()})
    if bad:
        raise RuntimeError(f"fixture mismatch: {bad}")

    print(json.dumps({"kernels": [{
        "name": "fused_admm", "route": "cuda",
        "source": "quadruped_tpu_torch/csrc/fused_admm.cu",
        "replaces": "quadruped_tpu/solvers/pallas_admm.py:210",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["warm"][0], "plain_ms": timing["warm"][1],
        "ms_cold": timing["cold"][0], "plain_ms_cold": timing["cold"][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
