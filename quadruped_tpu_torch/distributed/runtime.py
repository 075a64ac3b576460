"""Multi-process runtime: torch.distributed bootstrap and the host-local /
global plumbing (port of quadruped_tpu/distributed/runtime.py).

One process per device. The bootstrap reads the JAX package's launcher
contract,

  QTPU_COORDINATOR   host:port of process 0 (default 127.0.0.1:12321)
  QTPU_NUM_PROCESSES total process count   (default 1 -> no-op)
  QTPU_PROCESS_ID    this process's rank   (default 0)

into `init_process_group(init_method="tcp://...")`, and falls through to
torchrun's WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT when those are
unset (the counterpart of `jax.distributed.initialize()`'s platform
auto-detect). Each rank takes `cuda:{LOCAL_RANK}` (LOCAL_RANK, else the
rank modulo the cards of the host); NCCL on the card, gloo when the caller
passes device="cpu".

A JAX global array is one array whose shards live on every process; here
each rank holds its own rows and nothing else. So `host_local_to_global`
and `global_to_host_local` are the identity on a rank's rows, and
`all_gather_batch` assembles the global view where a caller needs it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quadruped_tpu_torch.distributed import mesh as mesh_mod
from quadruped_tpu_torch.utils import card, tree


def _launch_env():
    """(coordinator "host:port", world size, rank) from QTPU_* or, when
    those are unset, from torchrun's variables."""
    if "QTPU_NUM_PROCESSES" in os.environ:
        return (os.environ.get("QTPU_COORDINATOR", "127.0.0.1:12321"),
                int(os.environ["QTPU_NUM_PROCESSES"]),
                int(os.environ.get("QTPU_PROCESS_ID", "0")))
    if "WORLD_SIZE" in os.environ:
        coord = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
        return (coord, int(os.environ["WORLD_SIZE"]),
                int(os.environ.get("RANK", "0")))
    return "127.0.0.1:12321", 1, 0


def initialize_from_env(device=None) -> bool:
    """Start the process group from the environment. Returns True when a
    multi-process group was started, False for one process (a no-op, so
    every entry point can call it). On the card (NCCL, this rank's card)
    unless `device` says otherwise (gloo)."""
    coord, n, pid = _launch_env()
    if n <= 1:
        return False
    device = card.resolve(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   pid % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(mesh_mod.backend_for(device),
                            init_method=f"tcp://{coord}", world_size=n,
                            rank=pid)
    return True


def global_mesh(dp: int | None = None, sp: int = 1,
                device=None) -> DeviceMesh:
    """A (dp, sp) mesh over every process's device (one rank each)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = world // sp
    return mesh_mod.make_mesh(world, dp=dp, sp=sp, device=device)


def host_local_to_global(mesh: DeviceMesh, values, spec=None):
    """The JAX function assembles the processes' local batches into one
    global array. Here a rank's rows are its shard of the global batch:
    the values, on the mesh's device."""
    device = mesh_mod.mesh_device(mesh)
    if isinstance(values, torch.Tensor):
        return values.to(device)
    return tree.map_tensors(lambda t: t.to(device), values)


def global_to_host_local(mesh: DeviceMesh, values, spec=None):
    """This rank's shard of a global value: the rank's own rows, as they
    are (see host_local_to_global)."""
    return values


def all_gather_batch(mesh: DeviceMesh, values: torch.Tensor,
                     dim: int = 0) -> torch.Tensor:
    """The global batch: every rank's rows of `values` concatenated along
    `dim` in rank order (dp-major, then sp), on every rank."""
    group = mesh_mod.mesh_group(mesh)
    parts = [torch.empty_like(values)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, values.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
