"""Sharded solves with mesh-reduced statistics, and the scaling report
(port of quadruped_tpu/distributed/scaling.py).

A rank solves its own rows of the scenario batch; the solve statistic (the
mean |f| over the global batch) reduces with `all_reduce` over the mesh,
where the JAX code `psum`s under `shard_map`. `scaling_report` gives
solves/s at one rank and at the world's ranks and the efficiency between
them.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quadruped_tpu_torch.distributed import mesh as mesh_mod


def sharded_solve_stats(mesh: DeviceMesh, solve_fn):
    """Wrap a batched solve so its statistic reduces over the mesh.

    solve_fn: this rank's batch -> forces [B_local, 4, 3].
    Returns fn: batch -> (forces [B_local, 4, 3], global mean |f| as a
    0-d tensor, equal on every rank)."""
    group = mesh_mod.mesh_group(mesh)

    def fn(batch):
        forces = solve_fn(batch)
        acc = torch.stack([forces.abs().sum(),
                           torch.tensor(float(forces.numel()),
                                        dtype=forces.dtype,
                                        device=forces.device)])
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return forces, acc[0] / acc[1]

    return fn


def _sync(out):
    """Wait for the card when any tensor of `out` lives there."""
    tensors = [out] if isinstance(out, torch.Tensor) else [
        t for t in (out if isinstance(out, (tuple, list)) else [])
        if isinstance(t, torch.Tensor)]
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def measure_throughput(fn, args, reps: int = 10) -> float:
    """Seconds a call of fn(*args), over `reps` calls after one untimed
    call (the card synchronised before and after)."""
    _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / reps


def scaling_report(build_fn, batch_per_device: int, n_devices: int,
                   reps: int = 10, solves_per_s_1dev: float | None = None,
                   device=None) -> dict:
    """Solves/s at one device and at n_devices for a weak-scaling sweep
    (the batch grows with the devices).

    build_fn(batch_size, mesh) -> (fn, args) of one batched solve of this
    rank's rows. One rank per device: n_devices is the world size, so the
    one-device reading comes from this call only when n_devices == 1;
    otherwise pass it (`solves_per_s_1dev`, from a one-process run, as
    benchmarks/scaling.py does)."""
    mesh = mesh_mod.make_mesh(n_devices, device=device)
    fn, args = build_fn(batch_per_device * n_devices, mesh)
    rate = batch_per_device * n_devices / measure_throughput(fn, args, reps)
    if n_devices == 1:
        solves_per_s_1dev = rate
    elif solves_per_s_1dev is None:
        raise ValueError("scaling_report at n_devices > 1 needs the "
                         "one-device reading (solves_per_s_1dev)")
    return {
        "solves_per_s_1dev": solves_per_s_1dev,
        f"solves_per_s_{n_devices}dev": rate,
        "scaling_efficiency": rate / (solves_per_s_1dev * n_devices),
    }
