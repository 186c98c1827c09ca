"""The collectives of a data-parallel step, their launch counters, and the
batch-crossing ops' view of the group.

:class:`DPGroup` wraps the ``torch.distributed`` group a
``ParallelExecutor`` runs over; every collective the port issues goes
through it and adds one to its counter here (``all_reduce_launches``,
``reduce_scatter_launches``, ``all_gather_launches``,
``broadcast_launches``), which ``launch_counts`` advances under CUDA-graph
replays as it does the kernels'.

The ops that reduce across the batch of a batch-sharded input (``mean``,
``batch_norm``'s training statistics, the ``reduce_*`` ops over dim 0,
``accuracy``) ask :func:`batch_group` for the group: the Executor's
data-parallel step (``parallel/spmd.py``) sets it around exactly those
ops, so an op outside a group of more than one computes its local answer,
which is then the global one.

Two all-reduces differ in their backward.  A param's grad is the sum over
the ranks of each rank's part, so the step all-reduces the grads once
(``ShardedTrainStep``).  Below it:

 - :func:`replicated_sum`: the forward sums over the ranks and the
   backward is the identity.  Its output feeds replicated computation
   only (the loss a ``mean`` gives, a metric): that output's cotangent
   is the same full value on every rank, and each rank hands it to its
   own rows.  Summing it again would multiply the grads by the world
   size.
 - :func:`shared_sum`: the backward all-reduces the cotangent too.  Its
   output (batch norm's per-channel sums) feeds every rank's own rows,
   so each rank holds only its part of that cotangent.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

all_reduce_launches = 0
reduce_scatter_launches = 0
all_gather_launches = 0
broadcast_launches = 0

_ACTIVE: List["DPGroup"] = []

# newer torch renames the flat-tensor collectives (the old names warn)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class DPGroup:
    """The default process group's rank, size and backend, and the
    collectives the port issues over it (each counted).  ``capturable``:
    whether a CUDA graph can capture its collectives (NCCL's; gloo's
    stage through the host)."""

    def __init__(self):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.capturable = self.backend == "nccl"

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        global all_reduce_launches
        all_reduce_launches += 1
        dist.all_reduce(t, op=op)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0):
        global broadcast_launches
        broadcast_launches += 1
        dist.broadcast(t, src=src)
        return t

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        global reduce_scatter_launches
        reduce_scatter_launches += 1
        _reduce_scatter(out, inp)
        return out

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        global all_gather_launches
        all_gather_launches += 1
        _all_gather(out, inp)
        return out


def batch_group() -> Optional[DPGroup]:
    """The group a batch-crossing op reduces over, or None: its input is
    not batch-sharded, or the group has one rank."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def crossing(group: Optional[DPGroup]):
    """Make ``group`` the :func:`batch_group` inside the block (none when
    it has one rank)."""
    if group is None or group.world == 1:
        yield
        return
    _ACTIVE.append(group)
    try:
        yield
    finally:
        _ACTIVE.pop()


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone()), None


def replicated_sum(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """Sum of ``x`` over the ranks; identity backward (module docstring)."""
    return _ReplicatedSum.apply(x, group)


def shared_sum(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """Sum of ``x`` over the ranks; the backward sums the cotangent over
    the ranks too (module docstring)."""
    return _SharedSum.apply(x, group)


class _GlobalExtreme(torch.autograd.Function):
    """``amax`` / ``amin`` over dims that include the batch: the local
    extreme, then the ranks' (MAX / MIN).  The grad splits evenly between
    every element equal to the result on any rank, as ``jnp.max``'s."""

    @staticmethod
    def forward(ctx, x, dims, keepdim, group, is_max):
        fn = torch.amax if is_max else torch.amin
        out = fn(x, dim=dims, keepdim=True)
        group.all_reduce_(out, op=dist.ReduceOp.MAX if is_max
                          else dist.ReduceOp.MIN)
        hit = (x == out).to(x.dtype)
        count = group.all_reduce_(hit.sum(dim=dims, keepdim=True))
        ctx.save_for_backward(hit, count)
        ctx.dims, ctx.keepdim = dims, keepdim
        return out if keepdim else out.squeeze(dims) if dims else out

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        if not ctx.keepdim:
            for d in sorted(ctx.dims):
                g = g.unsqueeze(d)
        return g * hit / count, None, None, None, None


def global_extreme(x, dims, keepdim, group, is_max):
    return _GlobalExtreme.apply(x, tuple(dims), bool(keepdim), group,
                                bool(is_max))
