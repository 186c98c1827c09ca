"""Dense math ops (counterpart of ``paddle_tpu/ops/math_ops.py``): mul,
matmul, the elementwise family, scale, sum, cast, equal and logical_not.
Large products go to ``torch.matmul``, as the reference leaves them to XLA;
float32 stays float32 (the port never turns TF32 on).  Their grads come
from the generic grad (``registry.run_grad_generic``)."""

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


def _elementwise(name, fn):
    @register_op(name)
    def _impl(ctx, _fn=fn):
        x, y = ctx.input("X"), ctx.input("Y")
        return {"Out": _fn(x, _bcast_y(x, y, ctx.attr("axis", -1)))}
    return _impl


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)


@register_op("scale")
def scale(ctx):
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": out}


@register_op("sum")
def sum_op(ctx):
    xs = [v for v in ctx.inputs_list("X") if v is not None]
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return {"Out": out}


@register_op("cast")
def cast(ctx):
    from ..fluid import core as _core

    return {"Out": ctx.input("X").to(_core.torch_dtype(
        ctx.attr("out_dtype", ctx.attr("dtype", "float32"))))}


@register_op("equal", no_grad_inputs=("X", "Y"))
def equal(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    return {"Out": torch.eq(x, _bcast_y(x, y, ctx.attr("axis", -1)))}


@register_op("logical_not", no_grad_inputs=("X",))
def logical_not(ctx):
    return {"Out": torch.logical_not(ctx.input("X"))}
