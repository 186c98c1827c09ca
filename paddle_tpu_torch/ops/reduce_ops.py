"""Reduction ops (counterpart of ``paddle_tpu/ops/reduce_ops.py``):
reduce_sum, reduce_mean and top_k."""

from __future__ import annotations

import torch

from .registry import register_op


def _reduce(name, fn):
    """Over ``dim`` (``keep_dim`` keeps them as 1s); with ``reduce_all``
    or no ``dim``, over everything to a 0-d tensor, as the reference's
    ``jnp`` reductions give."""
    @register_op(name)
    def _impl(ctx, _fn=fn):
        x = ctx.input("X")
        dim = ctx.attr("dim", None)
        if ctx.attr("reduce_all", False) or dim is None:
            return {"Out": _fn(x)}
        dims = [dim] if isinstance(dim, int) else list(dim)
        return {"Out": _fn(x, dim=tuple(d % x.dim() for d in dims),
                           keepdim=bool(ctx.attr("keep_dim", False)))}
    return _impl


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)


@register_op("top_k", no_grad_inputs=("X",))
def top_k(ctx):
    """The ``k`` largest values along the last dim, in descending order,
    and their int64 indices."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int64)}
