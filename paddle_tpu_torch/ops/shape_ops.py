"""Shape ops (counterpart of ``paddle_tpu/ops/shape_ops.py``): reshape."""

from __future__ import annotations

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
