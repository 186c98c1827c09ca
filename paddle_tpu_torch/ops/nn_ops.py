"""NN ops (counterpart of ``paddle_tpu/ops/nn_ops.py``): conv2d (with an
explicit grad), pool2d, batch_norm, layer_norm and lookup_table (with its
dense grad, or with ``is_sparse`` a SelectedRows one).

Convolutions are no Pallas kernel in the reference (``lax.conv_general_
dilated``, left to XLA), so here they go to cuDNN / ATen, float32 ones
always in full float32: the reference asks for float32 results
(``preferred_element_type``) and cuDNN would otherwise take TF32 when the
caller's flag allows it.  Under ``fluid.amp`` the convolution takes its
operands through ``amp.cast_operands`` (bf16 / fp16 on the tensor cores)
and ``restore_astype``, as the reference's ``_conv``; ``batch_norm`` and
``layer_norm`` normalize a bf16 / fp16 input in fp32 and return it in the
input's dtype, their statistics fp32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .registry import register_grad, register_op


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


@contextlib.contextmanager
def _fp32_conv():
    """cuDNN convolutions in IEEE float32 inside the block, whatever the
    caller's TF32 setting; the setting is restored after."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def _conv_attrs(ctx):
    return (_pair(ctx.attr("strides", [1, 1])),
            _pair(ctx.attr("paddings", [0, 0])),
            _pair(ctx.attr("dilations", [1, 1])), ctx.attr("groups", 1) or 1)


@register_op("conv2d")
def conv2d(ctx):
    """NCHW input, OIHW filter, symmetric paddings, as the reference's
    ``_conv``."""
    from ..fluid import amp

    strides, paddings, dilations, groups = _conv_attrs(ctx)
    x, w, back = amp.cast_operands(ctx.input("Input"), ctx.input("Filter"))
    with _fp32_conv():
        out = F.conv2d(x, w, None, strides, paddings, dilations, groups)
    return {"Output": amp.restore_astype(out, back)}


@register_grad("conv2d")
def conv2d_grad(ctx):
    """dInput and dFilter from ``aten.convolution_backward`` in the dtype
    the forward convolved in, only for the grads someone reads: the
    generic grad would run the convolution forward again first.  Under AMP
    the casts' transposes hold: the incoming grad is cast to the compute
    dtype (the restore's transpose), and each grad comes back in its
    input's own dtype (dFilter fp32; dInput fp32 for an fp32 input such as
    the image feed, bf16 for a kept activation)."""
    from ..fluid import amp

    x_in, w_in = ctx.input("Input"), ctx.input("Filter")
    x, w, _ = amp.cast_operands(x_in, w_in)
    dout = ctx.input("Output@GRAD").to(x.dtype)
    strides, paddings, dilations, groups = _conv_attrs(ctx)
    want_x = "Input@GRAD" in ctx.outputs_spec
    want_w = "Filter@GRAD" in ctx.outputs_spec
    with _fp32_conv():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dout, x, w, None, strides, paddings, dilations, False, [0, 0],
            groups, [want_x, want_w, False])
    out = {}
    if want_x:
        out["Input@GRAD"] = dx.to(x_in.dtype)
    if want_w:
        out["Filter@GRAD"] = dw.to(w_in.dtype)
    return out


@register_op("pool2d")
def pool2d(ctx):
    """max (``-inf`` padding; the gradient goes to the first maximum of a
    window in row-major order, as the reference's ``reduce_window`` VJP)
    or avg (``exclusive``: divide by the window's unpadded count); global
    pooling over H and W.  ``ceil_mode`` is not read, as in the
    reference."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        if ptype == "max":
            return {"Out": torch.amax(x, (2, 3), keepdim=True)}
        return {"Out": torch.mean(x, (2, 3), keepdim=True)}
    ksize = _pair(ctx.attr("ksize"))
    strides = _pair(ctx.attr("strides", [1, 1]))
    paddings = _pair(ctx.attr("paddings", [0, 0]))
    if ptype == "max":
        return {"Out": F.max_pool2d(x, ksize, strides, paddings)}
    return {"Out": F.avg_pool2d(
        x, ksize, strides, paddings,
        count_include_pad=not ctx.attr("exclusive", True))}


@register_op("batch_norm", no_grad_inputs=("Mean", "Variance"))
def batch_norm(ctx):
    """Training: normalize by the batch's mean and BIASED variance, and
    return the running stats ``momentum · old + (1 − momentum) · batch``
    as NEW tensors (the generic grad re-runs this forward: an in-place
    update would move the stats twice a step).  ``SavedVariance`` is
    ``rsqrt(var + eps)``, as in the reference.  ``is_test``: normalize by
    the running stats.  The stats are built only when some op or the
    caller reads them (not in the generic grad's re-run).  A bf16 / fp16
    input (AMP keep_activations) is normalized in fp32 and ``Y`` cast back
    to its dtype; the statistics stay fp32, as in the reference."""
    from ..fluid import amp

    x_in = ctx.input("X")
    low = amp.is_low_float(x_in.dtype)
    x = x_in.float() if low else x_in
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    momentum = ctx.attr("momentum", 0.9)
    eps = ctx.attr("epsilon", 1e-5)
    is_test = ctx.attr("is_test", False)
    nchw = ctx.attr("data_layout", "NCHW") == "NCHW"
    xc = x if nchw else x.movedim(-1, 1)
    y = F.batch_norm(xc, mean if is_test else None,
                     var if is_test else None, scale, bias,
                     training=not is_test, eps=eps)
    if low:
        y = y.to(x_in.dtype)
    out = {"Y": y if nchw else y.movedim(1, -1)}
    stats = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance")
    if not any(s in ctx.outputs_spec for s in stats):
        return out
    if is_test:
        # SavedMean is a copy: no other name may alias a scope tensor
        out.update(MeanOut=mean, VarianceOut=var, SavedMean=mean.clone(),
                   SavedVariance=torch.rsqrt(var + eps))
        return out
    with torch.no_grad():
        use_var, use_mean = torch.var_mean(
            xc, dim=[d for d in range(xc.dim()) if d != 1], correction=0)
    out.update(MeanOut=momentum * mean + (1.0 - momentum) * use_mean,
               VarianceOut=momentum * var + (1.0 - momentum) * use_var,
               SavedMean=use_mean, SavedVariance=torch.rsqrt(use_var + eps))
    return out


@register_op("layer_norm")
def layer_norm(ctx):
    """Normalize over dims ``begin_norm_axis:``; Mean and Variance are the
    flattened per-row statistics (biased variance), as in the reference.
    A bf16 / fp16 input is normalized in fp32 and ``Y`` cast back to its
    dtype; Mean and Variance stay fp32."""
    from ..fluid import amp

    x_in = ctx.input("X")
    low = amp.is_low_float(x_in.dtype)
    x = x_in.float() if low else x_in
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    axis = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    norm_shape = tuple(x.shape[axis:])
    y = F.layer_norm(x, norm_shape,
                     None if scale is None else scale.reshape(norm_shape),
                     None if bias is None else bias.reshape(norm_shape), eps)
    if low:
        y = y.to(x_in.dtype)
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
    """``is_sparse``: a :class:`~..fluid.selected_rows.SelectedRows` of
    (the ids, one row of dOut per occurrence), padding rows zeroed, in the
    table's dtype; no dense ``[V, D]`` grad is made.  Dense: scatter-add
    the rows of dOut into zeros, like the reference's dense kernel.  On
    CUDA ``index_add_`` adds repeated ids with atomics in no fixed order,
    so the dense grad (and a sparse one once folded) is not bitwise
    repeatable from run to run there; no training result of the port is
    claimed bitwise."""
    from ..fluid.selected_rows import SelectedRows

    w = ctx.input("W")
    ids = _lookup_ids(ctx)
    dout = ctx.input("Out@GRAD")
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        dout = dout * (ids != padding_idx)[..., None].to(dout.dtype)
    rows = ids.reshape(-1)
    vals = dout.reshape(-1, dout.shape[-1]).to(w.dtype)
    if ctx.attr("is_sparse", False):
        return {"W@GRAD": SelectedRows(rows, vals, height=w.shape[0])}
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, rows, vals)}
