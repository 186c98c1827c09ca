"""Reduction ops (counterpart of ``paddle_tpu/ops/reduce_ops.py``):
reduce_sum."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("reduce_sum")
def reduce_sum(ctx):
    """Over ``dim`` (``keep_dim`` keeps them as 1s); with ``reduce_all``
    or no ``dim``, over everything to a 0-d tensor, as the reference's
    ``jnp.sum`` gives."""
    x = ctx.input("X")
    dim = ctx.attr("dim", None)
    if ctx.attr("reduce_all", False) or dim is None:
        return {"Out": torch.sum(x)}
    dims = [dim] if isinstance(dim, int) else list(dim)
    return {"Out": torch.sum(x, dim=tuple(d % x.dim() for d in dims),
                             keepdim=bool(ctx.attr("keep_dim", False)))}
