"""Dense math ops (counterpart of ``paddle_tpu/ops/math_ops.py``): mul,
matmul, elementwise_add, scale.  Large products go to ``torch.matmul``, as
the reference leaves them to XLA; float32 stays float32 (the port never
turns TF32 on)."""

from __future__ import annotations

import torch

from .registry import register_op


def _flatten2(x, num_col_dims):
    """Fold leading dims: paddle's mul op flattens x to 2-D at num_col_dims."""
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    return x.reshape(lead, -1)


@register_op("mul")
def mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    out = torch.matmul(_flatten2(x, xnc), _flatten2(y, ync))
    return {"Out": out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))}


@register_op("matmul")
def matmul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcast: y's dims align to x starting at `axis`
    (axis=-1 means trailing alignment, numpy broadcasting)."""
    if y.dim() == x.dim() or y.dim() == 0:
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


@register_op("elementwise_add")
def elementwise_add(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    return {"Out": x + _bcast_y(x, y, ctx.attr("axis", -1))}


@register_op("scale")
def scale(ctx):
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": out}
