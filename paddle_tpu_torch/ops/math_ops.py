"""Dense math ops (counterpart of ``paddle_tpu/ops/math_ops.py``): mul,
matmul, the elementwise family (add, sub, mul, div, max, min, pow), scale,
sum (over dense and SelectedRows inputs), mean, cast, the comparisons
(equal, less_than, less_equal, greater_than, greater_equal), logical_not
and increment.
Large products go to ``torch.matmul``, as the reference leaves them to XLA;
float32 stays float32 (the port never turns TF32 on).  Under ``fluid.amp``
``mul`` and ``matmul`` multiply in the compute dtype (``amp.cast_operands``
/ ``restore_astype``, cuBLAS summing in fp32: ``amp.fp32_sums``), and under
``keep_activations`` an elementwise op's broadcast operand follows the main
operand's dtype.  Their grads come from the generic grad
(``registry.run_grad_generic``)."""

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
    from ..fluid import amp

    x2, y2, back = amp.cast_operands(_flatten2(x, xnc), _flatten2(y, ync))
    with amp.fp32_sums():
        out = amp.restore_astype(torch.matmul(*amp.promote(x2, y2)), back)
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
    from ..fluid import amp

    x, y, back = amp.cast_operands(x, y)
    with amp.fp32_sums():
        out = amp.restore_astype(torch.matmul(*amp.promote(x, y)), back)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * amp.weak_scalar(alpha, out.dtype)
    return {"Out": out}


def _refuse_sparse(op_type, *xs):
    """An elementwise op on a SelectedRows grad is refused, as in the
    reference (its arithmetic is undefined on the sparse pair); ``sum``
    densifies, and ``sgd`` applies it row by row."""
    from ..fluid.selected_rows import SelectedRows

    if any(isinstance(x, SelectedRows) for x in xs):
        raise TypeError(f"{op_type} does not take a SelectedRows input "
                        f"(a sparse table grad); build the table with "
                        f"is_sparse=False")


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
        _refuse_sparse(name, x, y)
        y = _bcast_y(x, y, ctx.attr("axis", -1))
        from ..fluid import amp

        if (amp.keep_low_activations() and x.dtype != y.dtype
                and x.is_floating_point() and y.is_floating_point()):
            # the broadcast operand (an fp32 bias or scale) follows the
            # main operand, so a bias add keeps the activation low
            y = y.to(x.dtype)
        return {"Out": _fn(x, y)}
    return _impl


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
# ties split the grad evenly between x and y, as jnp.maximum / minimum's
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


@register_op("scale")
def scale(ctx):
    from ..fluid import amp

    x = ctx.input("X")
    s = amp.weak_scalar(ctx.attr("scale", 1.0), x.dtype)
    b = amp.weak_scalar(ctx.attr("bias", 0.0), x.dtype)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": out}


@register_op("sum")
def sum_op(ctx):
    """Dense inputs add.  SelectedRows inputs (sparse table grads): all
    sparse, their concatenation is the sum; mixed, the sparse ones are
    scatter-added into the dense accumulator."""
    from ..fluid.selected_rows import SelectedRows

    xs = [v for v in ctx.inputs_list("X") if v is not None]
    sparse = [v for v in xs if isinstance(v, SelectedRows)]
    if sparse:
        if len(sparse) == len(xs):
            out = sparse[0]
            for v in sparse[1:]:
                out = out.merge_with(v)
            return {"Out": out}
        dense = [v for v in xs if not isinstance(v, SelectedRows)]
        out = dense[0]
        for v in dense[1:]:
            out = out + v
        # out-of-place: the accumulator may be another op's output
        out = out.clone() if len(dense) == 1 else out
        for v in sparse:
            out.index_add_(0, v.rows, v.values.to(out.dtype))
        return {"Out": out}
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return {"Out": out}


@register_op("mean")
def mean(ctx):
    """Shape ``[1]``, not 0-d, as Fluid's mean op (and the reference)."""
    return {"Out": torch.mean(ctx.input("X")).reshape(1)}


@register_op("cast")
def cast(ctx):
    from ..fluid import core as _core

    return {"Out": ctx.input("X").to(_core.torch_dtype(
        ctx.attr("out_dtype", ctx.attr("dtype", "float32"))))}


def _compare(name, fn):
    @register_op(name, no_grad_inputs=("X", "Y"))
    def _impl(ctx, _fn=fn):
        x, y = ctx.input("X"), ctx.input("Y")
        return {"Out": _fn(x, _bcast_y(x, y, ctx.attr("axis", -1)))}
    return _impl


_compare("equal", torch.eq)
_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)


@register_op("logical_not", no_grad_inputs=("X",))
def logical_not(ctx):
    return {"Out": torch.logical_not(ctx.input("X"))}


@register_op("increment")
def increment(ctx):
    """``X + step`` in X's dtype.  An integer counter adds an integral step
    as an integer: torch would add a python float in float32, which loses
    counts past 2^24 (the reference adds it in float64 under x64)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    if not x.is_floating_point() and float(step).is_integer():
        step = int(step)
    return {"Out": (x + step).to(x.dtype)}
