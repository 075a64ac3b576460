"""Device mesh and scenario-batch sharding on torch.distributed (port of
quadruped_tpu/distributed/mesh.py).

The engine's parallel axes, as in the JAX package:

  * `dp`: scenario data parallelism (robots x gaits x commands sharded
    over devices, no communication in the tick): the throughput axis;
  * `sp`: solver parallelism, the QP's force-variable axis split over
    devices by `distributed.solver_sp.solve_cone_sp` (one all_reduce of
    the [B, n] iterate per ADMM iteration). Correct but measured
    unprofitable in every regime the JAX package tried, so sp = 1 is the
    default.

How the JAX mesh maps onto torch.distributed:

  =============================  ==========================================
  JAX                            port
  =============================  ==========================================
  a `Mesh` over the devices of   one rank per device: `make_mesh(n)` needs
  one process                    n == the world size and raises otherwise
  `P(("dp", "sp"))` batch        this rank's contiguous rows of the leading
  sharding                       axis, dp-major then sp (`shard_batch`)
  `P()`                          the whole tensor on every rank
  `psum` / `pmax`                `all_reduce` SUM / MAX on the mesh dim's
                                 group (`mesh.get_group("sp")`) or on the
                                 whole mesh (`mesh_group`)
  `all_gather(..., tiled=True)`  `all_gather` of the ranks' blocks, then a
                                 concatenation along the gathered axis
  =============================  ==========================================

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with the dims
("dp", "sp"). The backend is NCCL on the card and gloo when the caller
passes device="cpu". With no process group and a world of one rank,
`make_mesh` starts a one-rank group itself on a free-port TCP store, so
`make_mesh(1)` works as it does in JAX; any other world size needs
`runtime.initialize_from_env`. Nothing here uses DTensor: the tick runs
on plain rank-local tensors and the collectives are written out.
"""

from __future__ import annotations

import socket
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from quadruped_tpu_torch.utils import card, tree

DIMS = ("dp", "sp")


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_single_process_group(device: torch.device) -> None:
    """A one-rank process group on a free-port TCP store (the backend of
    `device`)."""
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, device=None) -> DeviceMesh:
    """A (dp, sp) mesh over the n_devices ranks of the process group.

    Defaults: every rank on the dp axis (sp = 1), right for pure scenario
    batching; pass sp > 1 to split the solver axis. n_devices must be the
    world size (one rank per device). On the card unless `device` says
    otherwise."""
    device = card.resolve(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n_devices}): no process group; start one with "
                f"distributed.runtime.initialize_from_env (one rank per "
                f"device)")
        start_single_process_group(device)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the mesh takes one rank "
                         f"per device and the world has {world} ranks")
    if dp is None:
        sp = sp or 1
        dp = n_devices // sp
    else:
        sp = sp or n_devices // dp
    if dp * sp != n_devices:
        raise ValueError(f"dp={dp} x sp={sp} != {n_devices} devices")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device.type, (dp, sp), mesh_dim_names=DIMS)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{"dp": size, "sp": size}, as the JAX `Mesh.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh: DeviceMesh):
    """The process group of every rank of the mesh (its ("dp", "sp")
    axes together): the default group, as a mesh spans the world."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh does not span the world")
    return dist.group.WORLD


class Sharding(NamedTuple):
    """What a JAX NamedSharding says of a leading axis: `batch`, split
    over both mesh axes (P(("dp", "sp"))), or `replicated` (P())."""

    mesh: DeviceMesh
    kind: str

    def rows(self, batch: int) -> slice:
        """This rank's rows of a leading axis of `batch`."""
        if self.kind == "replicated":
            return slice(0, batch)
        n = self.mesh.size()
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} ranks")
        dp_i, sp_i = self.mesh.get_coordinate()
        r = dp_i * mesh_shape(self.mesh)["sp"] + sp_i
        return slice(r * (batch // n), (r + 1) * (batch // n))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """A leading scenario axis split over both mesh axes, dp-major."""
    return Sharding(mesh, "batch")


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, "replicated")


def shard_batch(mesh: DeviceMesh, values, sharding: Sharding | None = None):
    """This rank's rows of every tensor of `values` (a tensor or a tree:
    dataclass, NamedTuple, dict, tuple, list), on the mesh's device; the
    tensors hold the global batch on their leading axis."""
    sharding = batch_sharding(mesh) if sharding is None else sharding
    device = mesh_device(mesh)

    def take(t: torch.Tensor) -> torch.Tensor:
        return t[sharding.rows(t.shape[0])].to(device)

    if isinstance(values, torch.Tensor):
        return take(values)
    return tree.map_tensors(take, values)
