"""Shape ops (counterpart of ``paddle_tpu/ops/shape_ops.py``): reshape,
transpose, concat and one_hot."""

from __future__ import annotations

import torch

from .registry import register_op


def _infer_reshape(shape_attr, x):
    """Fluid reshape: 0 keeps the input dim, one -1 is inferred."""
    shape = list(shape_attr)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = x.numel() // known
    return shape


@register_op("reshape")
def reshape(ctx):
    x = ctx.input("X")
    return {"Out": x.reshape(_infer_reshape(ctx.attr("shape"), x))}


@register_op("transpose")
def transpose(ctx):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("concat")
def concat(ctx):
    return {"Out": torch.cat(ctx.inputs_list("X"), dim=ctx.attr("axis", 0))}


@register_op("one_hot", no_grad_inputs=("X",))
def one_hot(ctx):
    """float32 one-hot over ``depth`` classes; an id outside ``[0, depth)``
    gives a zero row, as ``jax.nn.one_hot`` does (and no host sync to
    check the ids)."""
    x = ctx.input("X").long()
    depth = int(ctx.attr("depth"))
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    valid = ((x >= 0) & (x < depth)).to(torch.float32)[..., None]
    out = torch.zeros(tuple(x.shape) + (depth,), dtype=torch.float32,
                      device=x.device)
    return {"Out": out.scatter_(-1, x.clamp(0, depth - 1)[..., None], valid)}
