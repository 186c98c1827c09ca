"""Reduction and sort ops (counterpart of
``paddle_tpu/ops/reduce_ops.py``): reduce_sum, reduce_mean, reduce_max,
reduce_min, reduce_prod, cumsum, arg_max, arg_min, argsort and top_k.
reduce_max / reduce_min are ``torch.amax`` / ``amin``, whose grad splits
evenly between tied extremes as ``jnp.max``'s does (``torch.max(dim)``
gives it all to one); argsort is stable, as ``jnp.argsort``.  In a data-parallel step a
reduction over the batch of a batch-sharded input spans every rank's
rows (:func:`_global_reduce`)."""

from __future__ import annotations

import torch

from . import collectives
from .registry import register_op


def _reduce(name, fn):
    """Over ``dim`` (``keep_dim`` keeps them as 1s); with ``reduce_all``
    or no ``dim``, over everything to a 0-d tensor, as the reference's
    ``jnp`` reductions give."""
    @register_op(name)
    def _impl(ctx, _fn=fn):
        x = ctx.input("X")
        dim = ctx.attr("dim", None)
        group = collectives.batch_group()
        if group is not None:
            return {"Out": _global_reduce(name, x, dim, ctx, group)}
        if ctx.attr("reduce_all", False) or dim is None:
            return {"Out": _fn(x)}
        dims = [dim] if isinstance(dim, int) else list(dim)
        return {"Out": _fn(x, dim=tuple(d % x.dim() for d in dims),
                           keepdim=bool(ctx.attr("keep_dim", False)))}
    return _impl


def _global_reduce(name, x, dim, ctx, group):
    """A reduction over dims that include the batch of a batch-sharded
    input, over every rank's rows (``collectives``): sums and means by
    :func:`~.collectives.replicated_sum`, extremes by
    :func:`~.collectives.global_extreme`; a product raises."""
    if ctx.attr("reduce_all", False) or dim is None:
        dims, keep = tuple(range(x.dim())), False
    else:
        dims = tuple(sorted({d % x.dim() for d in (
            [dim] if isinstance(dim, int) else dim)}))
        keep = bool(ctx.attr("keep_dim", False))
    if name in ("reduce_max", "reduce_min"):
        return collectives.global_extreme(x, dims, keep, group,
                                          name == "reduce_max")
    if name not in ("reduce_sum", "reduce_mean"):
        raise NotImplementedError(
            f"{name} over the batch of a batch-sharded input has no "
            f"data-parallel form")
    s = collectives.replicated_sum(torch.sum(x, dim=dims, keepdim=keep),
                                   group)
    if name == "reduce_mean":
        count = 1
        for d in dims:
            count *= x.shape[d]
        s = s / (count * group.world)
    return s


def _prod(x, dim=None, keepdim=False):
    """``torch.prod`` over several dims (it takes one at a time)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
_reduce("reduce_max", torch.amax)
_reduce("reduce_min", torch.amin)
_reduce("reduce_prod", _prod)


@register_op("cumsum")
def cumsum(ctx):
    """Running sums along ``axis``; ``exclusive`` leaves each element out
    of its own sum, ``reverse`` runs from the end."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    reverse = ctx.attr("reverse", False)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if ctx.attr("exclusive", False):
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return {"Out": out}


@register_op("arg_max", no_grad_inputs=("X",))
def arg_max(ctx):
    """int64 index of the first largest value along ``axis``."""
    return {"Out": torch.argmax(ctx.input("X"),
                                dim=ctx.attr("axis", -1)).to(torch.int64)}


@register_op("arg_min", no_grad_inputs=("X",))
def arg_min(ctx):
    """int64 index of the first smallest value along ``axis``."""
    return {"Out": torch.argmin(ctx.input("X"),
                                dim=ctx.attr("axis", -1)).to(torch.int64)}


@register_op("argsort", no_grad_inputs=("X",))
def argsort(ctx):
    """The values sorted ascending along ``axis`` and their int64
    indices, ties in their input order."""
    vals, idx = torch.sort(ctx.input("X"), dim=ctx.attr("axis", -1),
                           stable=True)
    return {"Out": vals, "Indices": idx.to(torch.int64)}


@register_op("top_k", no_grad_inputs=("X",))
def top_k(ctx):
    """The ``k`` largest values along the last dim, in descending order,
    and their int64 indices."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int64)}
