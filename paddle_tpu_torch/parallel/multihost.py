"""Joining the process group of a multi-process run (counterpart of the
bootstrap half of ``paddle_tpu/parallel/multihost.py``).

The reference joins one JAX coordination service and runs one GSPMD
program over the global device mesh.  The port runs one process per rank
and joins a ``torch.distributed`` process group: NCCL for a CUDA place,
gloo for the CPU.  Role mapping, as the reference's:

  - pserver endpoint list  -> the group's ``tcp://`` rendezvous address
    (the first endpoint)
  - trainer_id / trainers  -> rank / world size
  - gen_nccl_id handshake  -> ``init_process_group``

Env contract (the reference's, upstream ``fluid_benchmark.py:34-82``):
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS``, ``PADDLE_COORDINATOR_ADDR``
(falling back to the first entry of ``PADDLE_PSERVER_EPS``).

No silent choice: a world of more than one process with no rendezvous
address raises, and so does a CUDA place where torch has no NCCL.  A
group the caller initialized itself is adopted as it is (a gloo group
over CUDA tensors is how two ranks share one card).  A world of one with
no group gets a group of one over an in-process store.  The sharded
serials (``multihost.py:229-end`` of the reference) come with the later
part of ``ROADMAP.md`` queue 1 item 12b.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, mesh_from_spec

#: how long a collective may wait for its peers before the group fails it
DEFAULT_TIMEOUT_S = 600.0

# whether this module made the default group (and so tears it down)
_owned = False


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _local_device_ids_from_env() -> Optional[list]:
    ids = os.environ.get("PADDLE_LOCAL_DEVICE_IDS", "")
    parsed = [int(x) for x in ids.split(",") if x.strip()]
    return parsed or None


def backend_for(place) -> str:
    """The backend a place's collectives take: NCCL for a CUDA place
    (raises when torch has none), gloo for the CPU."""
    from ..fluid import core

    if core.torch_device(place).type == "cuda":
        if not (dist.is_available() and dist.is_nccl_available()):
            raise RuntimeError(
                "a CUDA place takes NCCL collectives, and this torch has no "
                "NCCL; initialize a process group yourself to pick another "
                "backend")
        return "nccl"
    return "gloo"


def init(coordinator_addr: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids: Optional[Sequence[int]] = None,
         backend: Optional[str] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple:
    """Join the process group; arguments fall back to the ``PADDLE_*``
    env.  An initialized group is adopted (its rank and size must agree
    with any given).  ``backend`` is required to make a group (see
    :func:`backend_for`).  Returns ``(rank, world size)``."""
    global _owned
    if coordinator_addr is None:
        coordinator_addr = os.environ.get("PADDLE_COORDINATOR_ADDR")
        if not coordinator_addr:
            eps = os.environ.get("PADDLE_PSERVER_EPS", "")
            coordinator_addr = eps.split(",")[0].strip() or None
    if num_processes is None:
        num_processes = int(os.environ.get("PADDLE_TRAINERS", "1") or 1)
    if process_id is None:
        process_id = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    if local_device_ids is None:
        local_device_ids = _local_device_ids_from_env()
    if is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if num_processes > 1 and (world, rank) != (num_processes,
                                                   process_id):
            raise RuntimeError(
                f"multihost.init: the initialized group is rank {rank} of "
                f"{world}, not rank {process_id} of {num_processes}")
        return rank, world
    if backend is None:
        raise ValueError("multihost.init: name the backend (multihost."
                         "backend_for(place) gives a place's)")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if num_processes <= 1:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
        _owned = True
        return 0, 1
    if coordinator_addr is None:
        raise ValueError(
            "multihost.init: trainers > 1 but no coordinator address; set "
            "PADDLE_COORDINATOR_ADDR (or PADDLE_PSERVER_EPS) or pass "
            "coordinator_addr")
    addr = coordinator_addr if "://" in coordinator_addr \
        else f"tcp://{coordinator_addr}"
    if backend == "nccl" and local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _owned = True
    return dist.get_rank(), dist.get_world_size()


def ensure_init(dist_info: dict, place=None) -> None:
    """Join from a ``DistributeTranspiler`` annotation
    (``program._dist_info``) and ``place``'s backend, unless a group is
    initialized already."""
    if is_initialized():
        return
    dist_info = dist_info or {}
    trainers = int(dist_info.get("trainers", 0) or 0) or None
    init(dist_info.get("coordinator"), trainers,
         dist_info.get("trainer_id"), backend=backend_for(place))


def shutdown() -> None:
    """Leave the group this module made (one the caller made is theirs)."""
    global _owned
    if _owned and is_initialized():
        dist.destroy_process_group()
    _owned = False


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def barrier(tag: str = "barrier", timeout_s: float = 300.0) -> float:
    """Group-wide rendezvous (no-op outside a group of more than one);
    returns this rank's wait in seconds."""
    if process_count() <= 1:
        return 0.0
    t0 = time.perf_counter()
    dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s)) \
        if dist.get_backend() == "gloo" else dist.barrier()
    return time.perf_counter() - t0


def global_mesh(axis_names: Sequence[str] = ("dp",),
                mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over every rank of the group; with no ``mesh_shape`` all ranks
    land on the first axis (pure dp)."""
    world = process_count()
    if mesh_shape is None:
        mesh_shape = [world] + [1] * (len(axis_names) - 1)
    spec = ",".join(f"{a}{int(e)}" for a, e in zip(axis_names, mesh_shape))
    return mesh_from_spec(spec)
