"""The collectives of a parallel step, their launch counters, the
batch-crossing ops' view of the group, and the four conversions of a
tensor-parallel step.

:class:`DPGroup` wraps a ``torch.distributed`` group: the default one a
``ParallelExecutor`` runs over, or the sub-group of one mesh axis (``parallel/mesh.py`` ``axis_groups``).  Every collective the
port issues goes through one and adds one to its counter here
(``all_reduce_launches``, ``reduce_scatter_launches``,
``all_gather_launches``, ``broadcast_launches``, and by axis
``all_reduce_launches_by_axis`` / ``all_gather_launches_by_axis``), which
``launch_counts`` advances under CUDA-graph replays as it does the
kernels'.  A mesh axis's group of one rank (``trivial``: no process group
behind it) issues nothing and counts nothing; the default group issues
its collectives even over one rank.

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

A tensor-parallel step (``parallel/placement.py``) moves a value between
its placements with four autograd functions over a tp (or mp) group,
Megatron's *f* and *g* and the two along a dim:

 - :func:`copy_to_axis` (*f*): identity forward, all-reduce backward.  A
   replicated value that every rank feeds whole into its shard of a
   sharded computation (the input of a column-parallel product, a value
   broadcast over the sharded dim): each rank's cotangent covers only
   its shard's use, so the ranks' parts are summed.
 - :func:`reduce_from_axis` (*g*): all-reduce forward, identity backward.
   The partial sums of a row-parallel product become the replicated
   result; its cotangent is already whole on every rank.
 - :func:`gather_along_dim`: all-gather forward, slice backward.  A
   sharded value an op needs whole.
 - :func:`slice_along_dim`: the rank's slice forward, all-gather
   backward.  A replicated value cut to the shard it meets (a bias added
   to a column-parallel output, a soft-label row against vocabulary-
   sharded logits): each rank's cotangent is whole for its slice only,
   so the slices are gathered.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

all_reduce_launches = 0
reduce_scatter_launches = 0
all_gather_launches = 0
broadcast_launches = 0
#: the all-reduces and all-gathers by the mesh axis of their group (the
#: default group counts as "world"); their sums are the totals above
all_reduce_launches_by_axis: Dict[str, int] = {}
all_gather_launches_by_axis: Dict[str, int] = {}

_ACTIVE: List["DPGroup"] = []

# newer torch renames the flat-tensor collectives (the old names warn)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class DPGroup:
    """A ``torch.distributed`` group's size, this process's index in it
    (``rank``) and backend, and the collectives the port issues over it
    (each counted).  With no ``ranks``, the default group; else the
    sub-group ``pg`` over the global ranks ``ranks``, the group of mesh
    axis ``axis`` (``parallel/mesh.py`` ``axis_groups``).
    ``capturable``: whether a CUDA graph can capture its collectives
    (NCCL's; gloo's stage through the host)."""

    def __init__(self, ranks: Optional[Sequence[int]] = None, pg=None,
                 axis: str = "world"):
        self.axis = axis
        self.pg = pg
        #: a one-rank axis group with no process group behind it
        self.trivial = ranks is not None and len(ranks) == 1
        if ranks is None:
            self.world = dist.get_world_size()
            self.rank = dist.get_rank()
            self.ranks = list(range(self.world))
        else:
            self.ranks = [int(r) for r in ranks]
            self.world = len(self.ranks)
            self.rank = self.ranks.index(dist.get_rank()) \
                if self.world > 1 else 0
        if not dist.is_initialized():
            self.backend = "none"
        else:
            self.backend = str(dist.get_backend(pg) if pg is not None
                               else dist.get_backend())
        self.capturable = self.backend == "nccl"

    def _count(self, table):
        table[self.axis] = table.get(self.axis, 0) + 1

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        global all_reduce_launches
        if self.trivial:
            return t
        all_reduce_launches += 1
        self._count(all_reduce_launches_by_axis)
        dist.all_reduce(t, op=op, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0):
        """From the group's ``src``-th rank."""
        global broadcast_launches
        if self.trivial:
            return t
        broadcast_launches += 1
        dist.broadcast(t, src=self.ranks[src], group=self.pg)
        return t

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        global reduce_scatter_launches
        if self.trivial:
            return out.copy_(inp)
        reduce_scatter_launches += 1
        _reduce_scatter(out, inp, group=self.pg)
        return out

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        """``out`` (flat, ``world`` × ``inp``) = every rank's ``inp`` in
        group order."""
        global all_gather_launches
        if self.trivial:
            return out.copy_(inp.reshape(out.shape))
        all_gather_launches += 1
        self._count(all_gather_launches_by_axis)
        _all_gather(out, inp.contiguous(), group=self.pg)
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


# -- the tensor-parallel conversions -----------------------------------------


def gather_dim(x: torch.Tensor, dim: int, group: DPGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order (no
    autograd)."""
    if group.world == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((group.world * moved.shape[0],) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    group.all_gather(out, moved)
    return out.movedim(0, dim).contiguous() if dim else out


def slice_dim(x: torch.Tensor, dim: int, group: DPGroup) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (``x.shape[dim]`` divided
    evenly over the group), contiguous."""
    if group.world == 1:
        return x
    n = x.shape[dim] // group.world
    return x.narrow(dim, group.rank * n, n).contiguous()


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlongDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return slice_dim(g, ctx.dim, ctx.group), None, None


class _SliceAlongDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return slice_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def copy_to_axis(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """Identity forward, all-reduce backward (module docstring)."""
    if group.world == 1 or not x.requires_grad:
        return x
    return _CopyToAxis.apply(x, group)


def reduce_from_axis(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """All-reduce forward, identity backward (module docstring)."""
    return _ReduceFromAxis.apply(x, group) if group.world > 1 else x


def gather_along_dim(x: torch.Tensor, dim: int,
                     group: DPGroup) -> torch.Tensor:
    """All-gather along ``dim`` forward, slice backward."""
    return _GatherAlongDim.apply(x, dim, group) if group.world > 1 else x


def slice_along_dim(x: torch.Tensor, dim: int,
                    group: DPGroup) -> torch.Tensor:
    """The rank's slice along ``dim`` forward, all-gather backward."""
    return _SliceAlongDim.apply(x, dim, group) if group.world > 1 else x


# the group an op's inputs are sharded over, while a tensor-parallel step
# runs an op whose impl takes its shards as they are (``ring_attention``
# on its local heads, ``softmax_with_cross_entropy`` on its vocabulary
# slice; ``parallel/placement.py`` sets it)
_SHARDED: List[DPGroup] = []


def shard_group() -> Optional[DPGroup]:
    """The tp group the running op's sharded inputs are split over, or
    None: the op sees whole values."""
    return _SHARDED[-1] if _SHARDED else None


@contextlib.contextmanager
def sharded_over(group: Optional[DPGroup]):
    """Make ``group`` the :func:`shard_group` inside the block."""
    if group is None:
        yield
        return
    _SHARDED.append(group)
    try:
        yield
    finally:
        _SHARDED.pop()
