"""NN ops (counterpart of ``paddle_tpu/ops/nn_ops.py``): layer_norm and
lookup_table."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("layer_norm")
def layer_norm(ctx):
    """Normalize over dims ``begin_norm_axis:``; Mean and Variance are the
    flattened per-row statistics (biased variance), as in the reference."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    axis = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    norm_shape = tuple(x.shape[axis:])
    y = F.layer_norm(x, norm_shape,
                     None if scale is None else scale.reshape(norm_shape),
                     None if bias is None else bias.reshape(norm_shape), eps)
    var, mean = torch.var_mean(x, dim=tuple(range(axis, x.dim())),
                               unbiased=False)
    return {"Y": y, "Mean": mean.reshape(-1), "Variance": var.reshape(-1)}


@register_op("lookup_table")
def lookup_table(ctx):
    w = ctx.input("W")
    ids = ctx.input("Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = F.embedding(ids.long(), w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": out}
