"""NN ops (counterpart of ``paddle_tpu/ops/nn_ops.py``): layer_norm and
lookup_table, with lookup_table's dense grad."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_grad, register_op


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


def _lookup_ids(ctx):
    ids = ctx.input("Ids").long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return ids


@register_op("lookup_table", no_grad_inputs=("Ids",))
def lookup_table(ctx):
    w = ctx.input("W")
    ids = _lookup_ids(ctx)
    out = F.embedding(ids, w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": out}


@register_grad("lookup_table")
def lookup_table_grad(ctx):
    """Dense: scatter-add the rows of dOut into zeros, like the reference's
    dense kernel.  On CUDA ``index_add_`` adds repeated ids with atomics in
    no fixed order, so this grad is not bitwise repeatable from run to run
    there; no training result of the port is claimed bitwise.  The sparse
    (``is_sparse``) SelectedRows grad is not ported."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError(
            "lookup_table is_sparse=True (SelectedRows grad) is not ported")
    w = ctx.input("W")
    ids = _lookup_ids(ctx)
    dout = ctx.input("Out@GRAD")
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        dout = dout * (ids != padding_idx)[..., None].to(dout.dtype)
    vals = dout.reshape(-1, dout.shape[-1]).to(w.dtype)
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, ids.reshape(-1),
                                                     vals)}
