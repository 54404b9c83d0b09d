"""Process groups and device meshes (counterpart of
``fastegnn_tpu/parallel/mesh.py``).

The JAX package drives every device from one controller and names them in a
``jax.sharding.Mesh``; here each device is one process (``torchrun
--nproc_per_node D``), the processes form a ``torch.distributed`` group, and
a ``DeviceMesh`` names the group's axes: ``("data", "graph")`` as in the JAX
package, data parallelism over graphs and graph parallelism within a data
replica.  A mesh spans every process of the group.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def process_rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device: torch.device) -> torch.device:
    """``device``, or, for the card under ``torchrun`` (``LOCAL_RANK`` set
    and a card of that number present), the rank's own card, made the
    current one so that ``resolve_device(None)`` is that card too."""
    local = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and device.index is None and local is not None \
            and int(local) < torch.cuda.device_count():
        device = torch.device("cuda", int(local))
        torch.cuda.set_device(device)
    return device


def initialize_distributed(
    device_type: str = "cpu",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the default process group: NCCL on the card, gloo on the CPU.

    ``world_size`` / ``rank`` default to torch's environment (``WORLD_SIZE``,
    ``RANK``, set by ``torchrun``), ``init_method`` to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``).  Without a world size and a rank it
    is a no-op returning False, as the JAX function is without a
    coordinator.  On the card the process's device becomes its own
    (:func:`local_device`).  ``timeout_s`` bounds
    how long a collective waits for a rank that died.
    """
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or rank is None:
        return False
    if dist.is_initialized():
        return True
    if device_type == "cuda":
        local_device(torch.device("cuda"))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return True


def _fill(sizes, n: int) -> list:
    """``sizes`` with its one -1 replaced by what ``n`` leaves for it."""
    sizes = list(sizes)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = max(n // known, 1)
    return sizes


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: call "
                           "initialize_distributed() first")
    return dist.get_world_size()


def make_mesh(
    axis_sizes: Tuple[int, ...] = (-1,),
    axis_names: Tuple[str, ...] = ("data",),
    device_type: str = "cpu",
) -> DeviceMesh:
    """A mesh over the group's processes.  One axis may be -1."""
    n = _world()
    sizes = _fill(axis_sizes, n)
    total = math.prod(sizes)
    if total > n:
        raise ValueError(f"mesh needs {total} devices, have {n}")
    if total < n:
        raise ValueError(f"mesh of {total} devices over a group of {n} processes: "
                         "a mesh spans every process")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(axis_names))


def mesh_group(mesh: DeviceMesh):
    """The process group of all of ``mesh``'s processes: its axis's group
    for a mesh of one axis; else the default group, which a mesh of
    :func:`make_mesh` spans."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} processes in a group of "
                         f"{dist.get_world_size()}: a mesh spans every process")
    return dist.group.WORLD


def make_hybrid_mesh(
    dcn_axis: str = "data",
    ici_axes: Tuple[str, ...] = ("graph",),
    ici_sizes: Tuple[int, ...] = (-1,),
    n_outer: Optional[int] = None,
    device_type: str = "cpu",
) -> DeviceMesh:
    """Hosts x local devices: the outer axis spans hosts and carries data
    parallelism (one gradient ``all_reduce`` per step), the inner axes stay
    within a host, where the per-layer graph-parallel collectives run over
    NVLink.  ``torchrun`` numbers ranks host by host, so each row of the
    mesh is one host's processes (``LOCAL_WORLD_SIZE`` of them)."""
    n_total = _world()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_total))
    n_hosts = n_outer or max(n_total // max(n_local, 1), 1)
    sizes = _fill(ici_sizes, max(n_total // n_hosts, 1))
    return init_device_mesh(device_type, (n_hosts, *sizes),
                            mesh_dim_names=(dcn_axis, *ici_axes))
