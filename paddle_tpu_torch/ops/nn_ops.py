"""NN ops (counterpart of ``paddle_tpu/ops/nn_ops.py``): the convolutions
(conv2d / conv3d, depthwise_conv2d, conv2d_transpose / conv3d_transpose,
each with an explicit grad), pool2d / pool3d, spp, the max pools with
index and unpool, batch_norm, layer_norm, group_norm, lrn, maxout,
lookup_table (with its dense grad, or with ``is_sparse`` a SelectedRows
one), im2sequence, scale_sub_region and print.

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
import math

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


def _conv_attrs(ctx, nd=2, depthwise=False):
    """Strides, paddings, dilations and groups; an unset or zero
    ``groups`` is 1, or for a depthwise op the input's channel count (the
    reference's rule)."""
    return (_pair(ctx.attr("strides", [1] * nd), nd),
            _pair(ctx.attr("paddings", [0] * nd), nd),
            _pair(ctx.attr("dilations", [1] * nd), nd),
            ctx.attr("groups", 1)
            or (ctx.input("Input").shape[1] if depthwise else 1))


# (nd, transposed) -> the convolution; a transposed one's filter is
# [C_in, C_out / groups, k...], as in both packages, and its output
# (in - 1) * stride - 2 * pad + dilation * (k - 1) + 1 (output_padding 0)
_CONVS = {(2, False): F.conv2d, (3, False): F.conv3d,
          (2, True): F.conv_transpose2d, (3, True): F.conv_transpose3d}


def _convolution(ctx, nd, transposed, depthwise=False):
    """NC[D]HW input, symmetric paddings, as the reference's ``_conv`` and
    its transposes (``_transpose_pad`` pads the stride-dilated input by
    ``dilation * (k - 1) - pad``, which is torch's ``padding = pad``)."""
    from ..fluid import amp

    strides, paddings, dilations, groups = _conv_attrs(ctx, nd, depthwise)
    x, w, back = amp.cast_operands(ctx.input("Input"), ctx.input("Filter"))
    conv = _CONVS[nd, transposed]
    with _fp32_conv():
        if transposed:
            out = conv(x, w, None, strides, paddings, 0, groups, dilations)
        else:
            out = conv(x, w, None, strides, paddings, dilations, groups)
    return {"Output": amp.restore_astype(out, back)}


def _convolution_grad(ctx, nd, transposed, depthwise=False):
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
    strides, paddings, dilations, groups = _conv_attrs(ctx, nd, depthwise)
    want_x = "Input@GRAD" in ctx.outputs_spec
    want_w = "Filter@GRAD" in ctx.outputs_spec
    with _fp32_conv():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dout, x, w, None, strides, paddings, dilations, transposed,
            [0] * nd, groups, [want_x, want_w, False])
    out = {}
    if want_x:
        out["Input@GRAD"] = dx.to(x_in.dtype)
    if want_w:
        out["Filter@GRAD"] = dw.to(w_in.dtype)
    return out


def _register_conv(op_type, nd, transposed, depthwise=False):
    register_op(op_type)(
        lambda ctx: _convolution(ctx, nd, transposed, depthwise))
    register_grad(op_type)(
        lambda ctx: _convolution_grad(ctx, nd, transposed, depthwise))


for _type, _nd, _transposed, _depthwise in (
        ("conv2d", 2, False, False), ("conv3d", 3, False, False),
        ("depthwise_conv2d", 2, False, True),
        ("conv2d_transpose", 2, True, False),
        ("conv3d_transpose", 3, True, False)):
    _register_conv(_type, _nd, _transposed, _depthwise)


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
    the rows of dOut into zeros, like the reference's dense kernel: on the
    CPU by ``index_add_``; on CUDA by ``embedding_dense_backward``, which
    sorts the ids and sums each id's rows in a fixed order, where
    ``index_add_`` adds repeated ids with atomics in no fixed order.  So
    the dense grad is bitwise repeatable from run to run on the card too
    (a resumed run, and a graphed window, can equal the run they stand
    for); a sparse grad once folded by ``index_add_`` is not."""
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
    if vals.device.type == "cuda":
        return {"W@GRAD": torch.ops.aten.embedding_dense_backward(
            vals, rows, w.shape[0], -1, False)}
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, rows, vals)}


@register_op("im2sequence")
def im2sequence(ctx):
    """The ``kernels`` patches of an NCHW image at ``strides`` after the
    ``paddings`` (up, left, down, right), one row per patch: ``[N·oh·ow,
    C·kh·kw]``, each row in (channel, kernel row, kernel column) order.
    The output carries no LoD, as in the reference."""
    x = ctx.input("X")
    kh, kw = ctx.attr("kernels")
    strides = _pair(ctx.attr("strides", [1, 1]))
    up, left, down, right = ctx.attr("paddings", [0, 0, 0, 0])
    n, c = x.shape[0], x.shape[1]
    cols = F.unfold(F.pad(x, (left, right, up, down)), (kh, kw),
                    stride=tuple(strides))                # [N, C·kh·kw, L]
    return {"Out": cols.transpose(1, 2).reshape(-1, c * kh * kw)}


@register_op("lrn")
def lrn(ctx):
    """``Out = X / MidOut ** beta`` with ``MidOut = k + alpha · Σ x²`` over
    the ``n`` channels centred on each one, zero-padded at the ends; alpha
    is not divided by ``n`` (``F.local_response_norm`` divides), and the
    op's ``k`` defaults to 2.0.  The sum runs in the reference's order."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = 0
    for i in range(n):
        acc = acc + sq[:, i:i + c]
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    return {"Out": x / torch.pow(mid, ctx.attr("beta", 0.75)), "MidOut": mid}


@register_op("maxout")
def maxout(ctx):
    """The maximum over each run of ``groups`` consecutive channels."""
    x = ctx.input("X")
    g = ctx.attr("groups")
    n, c = x.shape[:2]
    return {"Out": torch.amax(x.reshape((n, c // g, g) + x.shape[2:]), 2)}


@register_op("group_norm")
def group_norm(ctx):
    """Normalize each of ``groups`` channel groups of each sample over its
    channels and positions (population variance); ``Mean`` and
    ``Variance`` are ``[N, groups]``."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    groups = ctx.attr("groups")
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1)
    var, mean = torch.var_mean(xg, 2, correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + ctx.attr("epsilon", 1e-5))).reshape(
        x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": y, "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


def _pool(x, ptype, ksize, strides, paddings, exclusive):
    """Max (``-inf`` padding; the grad to a window's first maximum) or
    average pooling of an NC[D]HW tensor, padded explicitly (the
    reference's ``reduce_window`` takes any padding, torch's pools at most
    half a window); ``exclusive`` averages over the unpadded count, the
    reference's rule only where some padding is nonzero."""
    nd = len(ksize)
    pad = [p for p in reversed(paddings) for _ in range(2)]
    padded = any(paddings)
    if ptype == "max":
        pool = (F.max_pool2d, F.max_pool3d)[nd - 2]
        return pool(F.pad(x, pad, value=-math.inf) if padded else x, ksize,
                    strides)
    pool = (F.avg_pool2d, F.avg_pool3d)[nd - 2]
    out = pool(F.pad(x, pad) if padded else x, ksize, strides)
    if exclusive and padded:
        ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[2:])), pad)
        out = out / pool(ones, ksize, strides)
    return out


@register_op("pool3d")
def pool3d(ctx):
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        reduce = torch.amax if ptype == "max" else torch.mean
        return {"Out": reduce(x, (2, 3, 4), keepdim=True)}
    return {"Out": _pool(x, ptype, _pair(ctx.attr("ksize"), 3),
                         _pair(ctx.attr("strides", [1, 1, 1]), 3),
                         _pair(ctx.attr("paddings", [0, 0, 0]), 3),
                         ctx.attr("exclusive", True))}


@register_op("spp")
def spp(ctx):
    """Spatial pyramid pooling: level ``l`` pools ``2**l`` bins a side with
    a ceil-divided window and stride and the pad ``(k·bins − h + 1) // 2``
    (averages over the whole window), each level flattened, concatenated
    per sample."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    n, _, h, w = x.shape
    outs = []
    for level in range(ctx.attr("pyramid_height")):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        pads = [(kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2]
        outs.append(_pool(x, ptype, [kh, kw], [kh, kw], pads,
                          False).reshape(n, -1))
    return {"Out": torch.cat(outs, 1)}


def _pool_with_index(ctx, nd):
    """Max pooling with ``Mask``: the argmax's flat int64 index in its
    input plane (``d·H·W + h·W + w``), the first strict maximum of a
    window in row-major order, padding ``-inf``."""
    pool = (F.max_pool2d, F.max_pool3d)[nd - 2]
    out, idx = pool(ctx.input("X"), _pair(ctx.attr("ksize"), nd),
                    _pair(ctx.attr("strides", [1] * nd), nd),
                    _pair(ctx.attr("paddings", [0] * nd), nd),
                    return_indices=True)
    return {"Out": out, "Mask": idx}


def _pool_with_index_grad(ctx):
    """dOut added into zeros at each window's ``Mask`` (the reference's
    explicit grad)."""
    x = ctx.input("X")
    n, c = x.shape[:2]
    dx = torch.zeros((n, c, math.prod(x.shape[2:])), dtype=x.dtype,
                     device=x.device)
    dx.scatter_add_(2, ctx.input("Mask").reshape(n, c, -1),
                    ctx.input("Out@GRAD").reshape(n, c, -1))
    return {"X@GRAD": dx.reshape(x.shape)}


for _nd in (2, 3):
    register_op(f"max_pool{_nd}d_with_index")(
        lambda ctx, nd=_nd: _pool_with_index(ctx, nd))
    register_grad(f"max_pool{_nd}d_with_index")(_pool_with_index_grad)


@register_op("unpool", no_grad_inputs=("Indices",))
def unpool(ctx):
    """Max unpooling: each value of X ADDED at its ``Indices`` position of
    its output plane (the reference's ``.at[].add``; ``F.max_unpool2d``
    writes, so overlapping windows would differ).  The output size is
    ``unpooled_height`` x ``unpooled_width``, else ``(h − 1) · stride +
    ksize``."""
    x = ctx.input("X")
    out_h, out_w = ctx.attr("unpooled_height"), ctx.attr("unpooled_width")
    if not out_h or not out_w:
        ksize = _pair(ctx.attr("ksize"))
        strides = _pair(ctx.attr("strides", [2, 2]))
        out_h = (x.shape[2] - 1) * strides[0] + ksize[0]
        out_w = (x.shape[3] - 1) * strides[1] + ksize[1]
    n, c = x.shape[:2]
    out = torch.zeros((n, c, out_h * out_w), dtype=x.dtype, device=x.device)
    out = out.scatter_add(2, ctx.input("Indices").long().reshape(n, c, -1),
                          x.reshape(n, c, -1))
    return {"Out": out.reshape(n, c, out_h, out_w)}


@register_op("scale_sub_region", no_grad_inputs=("Indices",))
def scale_sub_region(ctx):
    """``X`` times ``scale`` inside each sample's box of ``Indices`` (rows
    ``c1, c2, h1, h2, w1, w2``, 1-based and inclusive), ``X`` outside."""
    x = ctx.input("X")
    ind = ctx.input("Indices").float() - 1.0
    lo, hi = ind[:, 0::2], ind[:, 1::2]
    mask = None
    for axis in range(3):
        shape = [1, 1, 1, 1]
        shape[axis + 1] = -1
        grid = torch.arange(x.shape[axis + 1], dtype=torch.float32,
                            device=x.device).reshape(shape)
        inside = (grid >= lo[:, axis, None, None, None]) & \
            (grid <= hi[:, axis, None, None, None])
        mask = inside if mask is None else mask & inside
    return {"Out": torch.where(mask, x * float(ctx.attr("scale", 1.0)), x)}


# host reads of device data the print op made (one a print)
stats = {"host_reads": 0}
_PRINT_COUNTS: dict = {}


@register_op("print")
def print_op(ctx):
    """Passes ``In`` through and, for the op's first ``first_n`` runs (all
    when negative), prints ``message``, ``shape=(...)``, ``dtype=<numpy
    name>`` and the first ``summarize`` values as numpy prints them, as the
    reference's host callback does.  Each op keeps its own count (keyed by
    its attr dict, one object per Program op).  On the card a print is a
    host sync (counted in ``stats``)."""
    x = ctx.input("In")
    first_n = ctx.attr("first_n", -1)
    counter = _PRINT_COUNTS.setdefault(id(ctx.attrs), [0])
    if first_n is None or first_n < 0 or counter[0] < first_n:
        counter[0] += 1
        fmt = []
        if ctx.attr("print_tensor_name", True):
            fmt.append(ctx.attr("message", "") or "")
        if ctx.attr("print_tensor_shape", True):
            fmt.append(f"shape={tuple(x.shape)}")
        if ctx.attr("print_tensor_dtype", True):
            fmt.append(f"dtype={str(x.dtype).replace('torch.', '')}")
        summarize = ctx.attr("summarize", 20)
        if summarize is None or int(summarize) <= 0:
            summarize = 20
        if x.device.type != "cpu":
            stats["host_reads"] += 1
        values = x.detach().reshape(-1)[:int(summarize)].cpu()
        if values.dtype == torch.bfloat16:  # numpy has no bfloat16
            values = values.float()
        values = values.numpy()
        print(f"{' '.join(fmt)} values={values}")
    return {"Out": x}
