"""Named meshes over the ranks of a process group (counterpart of
``paddle_tpu/parallel/mesh.py``).

The reference lays a ``jax.sharding.Mesh`` over devices; the port runs one
process per rank, each on one device, so its :class:`Mesh` is a grid of
ranks: named axes, their extents, and this rank's coordinates.
``PADDLE_TPU_MESH`` carries the topology as a spec string — ``dp4,tp2`` is
a 4×2 mesh whose first axis shards the batch and whose second would shard
model weights; axis order = spec order, later axes vary fastest over the
ranks.  The same strings give the same axes and labels as the reference
(``mesh_label`` -> ``dp4xtp2``).  ``ParallelExecutor`` runs the ``dp``,
``tp`` (or the legacy ``mp``) and ``fsdp`` axes (``parallel/spmd.py``);
:func:`axis_groups` makes the ``torch.distributed`` sub-group of each of
them.  A mesh with an ``sp``, ``pp`` or ``ep`` axis of extent > 1 is
refused where it would run.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

MESH_ENV = "PADDLE_TPU_MESH"

_AXIS_RE = re.compile(r"([a-zA-Z_]+?)(\d+)$")


class Mesh:
    """A grid of ``size`` ranks with named axes (``shape``: ``{axis:
    extent}``, ordered) and this process's ``rank`` and ``coords`` on it
    (later axes vary fastest, as the reference's device order)."""

    def __init__(self, axes: Dict[str, int], rank: int = 0):
        self.shape = {str(a): int(e) for a, e in axes.items()}
        if not self.shape:
            raise ValueError("a mesh needs at least one axis")
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        if not 0 <= int(rank) < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size} "
                             f"ranks ({mesh_label(self)})")
        self.rank = int(rank)
        where = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords = {a: int(c) for a, c in zip(self.axis_names, where)}

    def __repr__(self):
        return f"Mesh({mesh_label(self)}, rank={self.rank})"


def _world() -> tuple:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices=None, tp=1, axis_names=("dp", "mp")) -> Mesh:
    """A (dp × tp) mesh over ``n_devices`` ranks (default: the group's
    world size)."""
    rank, world = _world()
    n = int(n_devices or world)
    if n % tp != 0:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    return Mesh(dict(zip(axis_names, (n // tp, tp))), rank % n)


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp4,tp2"`` -> ``{"dp": 4, "tp": 2}`` (insertion-ordered).

    Raises ``ValueError`` on malformed tokens or duplicate axes, so a typo
    in ``PADDLE_TPU_MESH`` fails at mesh construction."""
    axes: Dict[str, int] = {}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        m = _AXIS_RE.fullmatch(tok)
        if m is None:
            raise ValueError(
                f"bad mesh axis {tok!r} in spec {spec!r} — expected "
                f"<name><extent> tokens like 'dp4,tp2'")
        name, size = m.group(1), int(m.group(2))
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        if size < 1:
            raise ValueError(f"mesh axis {tok!r} must have extent >= 1")
        axes[name] = size
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


def env_mesh_spec() -> Optional[str]:
    """The ``PADDLE_TPU_MESH`` spec string, or None when unset/empty."""
    from ..fluid import envcontract

    return envcontract.get(MESH_ENV) or None


def mesh_from_spec(spec: Optional[str] = None, world: Optional[int] = None,
                   rank: Optional[int] = None) -> Mesh:
    """A named mesh from a ``dp4,tp2``-style spec over the group's ranks.

    ``spec=None`` reads ``PADDLE_TPU_MESH``; with neither, a 1-axis
    ``("dp",)`` mesh over all ranks.  The spec must name exactly the
    group's world size (the reference takes the first devices of a larger
    pool; a process group has no spare ranks)."""
    if spec is None:
        spec = env_mesh_spec()
    g_rank, g_world = _world()
    world = g_world if world is None else int(world)
    rank = g_rank if rank is None else int(rank)
    if not spec:
        return Mesh({"dp": world}, rank)
    axes = parse_mesh_spec(spec)
    n = int(np.prod(list(axes.values())))
    if n != world:
        raise ValueError(
            f"mesh spec {spec!r} needs {n} ranks; the process group has "
            f"{world}")
    return Mesh(axes, rank)


def mesh_label(mesh: Mesh) -> str:
    """Canonical topology label for metrics/events: ``dp4xtp2``."""
    return "x".join(f"{a}{mesh.shape[a]}" for a in mesh.axis_names)


def axes_of(mesh=None) -> Dict[str, int]:
    """Ordered ``{axis: extent}`` for a :class:`Mesh`, a spec string
    (``"dp4,tp2"``), an ``[[name, extent], ...]`` list, a dict, or
    ``None`` (the ``PADDLE_TPU_MESH`` env spec; ``{}`` when unset)."""
    if mesh is None:
        spec = env_mesh_spec()
        return parse_mesh_spec(spec) if spec else {}
    if isinstance(mesh, str):
        return parse_mesh_spec(mesh)
    if isinstance(mesh, Mesh):
        return dict(mesh.shape)
    if isinstance(mesh, dict):
        return {str(a): int(e) for a, e in mesh.items()}
    if isinstance(mesh, (list, tuple)):
        return {str(a): int(e) for a, e in mesh}
    raise TypeError(f"not a mesh: {type(mesh).__name__}")


def axes_label(axes: Dict[str, int]) -> Optional[str]:
    """``{"dp": 4, "tp": 2}`` -> ``dp4xtp2`` (None for an empty dict)."""
    if not axes:
        return None
    return "x".join(f"{a}{int(e)}" for a, e in axes.items())


def make_mesh_nd(**axes) -> Mesh:
    """N-D mesh from named axis sizes, e.g. ``make_mesh_nd(dp=2, tp=2)``;
    axis order = keyword order, later axes vary fastest over the ranks."""
    rank, _ = _world()
    n = int(np.prod([int(s) for s in axes.values()]))
    return Mesh({a: int(s) for a, s in axes.items()}, rank % n)


def resolve_tp_axis(mesh, tp_axis: Optional[str] = None) -> str:
    """The mesh's tensor-parallel axis name: an explicit request wins, the
    canonical ``tp`` name (``PADDLE_TPU_MESH`` meshes) is preferred, and
    the legacy ``mp`` name (``make_mesh(n, tp=m)``) is the fallback."""
    if tp_axis is not None:
        return tp_axis
    return "tp" if "tp" in mesh.axis_names else "mp"


def axis_ranks(mesh: Mesh, axis: str) -> List[List[int]]:
    """The rank lists of ``axis``'s groups: one per coordinate of the other
    axes (in rank order of its first member), each listing the ranks that
    differ from it only along ``axis``, in axis order."""
    extents = tuple(mesh.shape.values())
    grid = np.arange(mesh.size).reshape(extents)
    i = mesh.axis_names.index(axis)
    lines = np.moveaxis(grid, i, -1).reshape(-1, extents[i])
    return [[int(r) for r in line] for line in lines]


def axis_groups(mesh: Mesh, axes=None) -> Dict[str, "object"]:
    """``{axis: DPGroup}``: this rank's group along each of ``axes``
    (default every axis of the mesh).  Every rank of the default process
    group must call this with the same mesh and axes: each group of each
    axis is created on every rank, in the same order, as
    ``torch.distributed.new_group`` requires.  An axis whose ranks are
    the whole world gets the default group (its collectives are issued
    even over one process); any other axis of extent 1 gets a group of one
    rank, which issues nothing."""
    import torch.distributed as dist

    from ..ops.collectives import DPGroup

    out = {}
    for axis in (mesh.axis_names if axes is None else axes):
        extent = mesh.shape.get(axis, 1)
        if extent == mesh.size:
            out[axis] = DPGroup(axis=axis)
        elif extent == 1:
            out[axis] = DPGroup([mesh.rank], axis=axis)
        else:
            for ranks in axis_ranks(mesh, axis):
                pg = dist.new_group(ranks)
                if mesh.rank in ranks:
                    out[axis] = DPGroup(ranks, pg, axis)
    return out
