"""NN layers (counterpart of ``paddle_tpu/fluid/layers/nn.py``): the builders
the decode and training programs (Transformer, ResNet, BERT, DeepFM,
SE-ResNeXt, VGG) call, copied so the same calls emit the same IR."""

from __future__ import annotations

import numpy as np

from .. import core
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "mean", "mul", "matmul",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "scale", "reduce_sum", "reshape", "transpose",
    "split", "gather", "slice", "topk", "one_hot", "label_smooth",
    "ring_attention", "kv_cache_update", "kv_cache_scatter", "spec_accept",
    "paged_attention", "token_select", "autoincreased_step_counter",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Emitted as mul (+sum) + elementwise_add + act, as in the reference."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in helper.iter_inputs_and_params():
        in_shape = input_var.shape
        param_shape = [int(np.prod(in_shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(attr=param_attr_, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        helper.append_op(
            type="mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    ids_shape = input.shape
    if ids_shape and ids_shape[-1] == 1:
        out.shape = tuple(ids_shape[:-1]) + (size[1],)
    else:
        out.shape = tuple(ids_shape or ()) + (size[1],)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def _conv_out_dim(size, k, pad, stride, dilation=1):
    if size in (-1, None):
        return -1
    return (size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def _to_list(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """NCHW conv; the filter draws from ``Normal(0, sqrt(2 / fan_in))``."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _to_list(filter_size, 2)
    stride = _to_list(stride, 2)
    padding = _to_list(padding, 2)
    dilation = _to_list(dilation, 2)
    filter_shape = [num_filters, num_channels // groups] + filter_size

    def _std(shape):
        fan_in = num_channels * shape[2] * shape[3] // groups
        return (2.0 / fan_in) ** 0.5

    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, _std(filter_shape)))
    out = helper.create_variable_for_type_inference(dtype)
    n, c, h, wd = input.shape
    out.shape = (n, num_filters,
                 _conv_out_dim(h, filter_size[0], padding[0], stride[0],
                               dilation[0]),
                 _conv_out_dim(wd, filter_size[1], padding[1], stride[1],
                               dilation[1]))
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "use_cudnn": use_cudnn})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", **locals())
    pool_size = _to_list(pool_size, 2)
    pool_stride = _to_list(pool_stride, 2)
    pool_padding = _to_list(pool_padding, 2)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    n, c, h, w = input.shape
    if global_pooling:
        out.shape = (n, c, 1, 1)
    else:
        def _po(size, k, pad, s):
            if size in (-1, None):
                return -1
            if ceil_mode:
                return (size - k + 2 * pad + s - 1) // s + 1
            return (size - k + 2 * pad) // s + 1
        out.shape = (n, c,
                     _po(h, pool_size[0], pool_padding[0], pool_stride[0]),
                     _po(w, pool_size[1], pool_padding[1], pool_stride[1]))
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "global_pooling": global_pooling, "strides": pool_stride,
               "paddings": pool_padding, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               fuse_with_relu=False):
    """The running mean and variance are persistable globals named
    ``<layer>.w_mean`` / ``.w_variance``; the op's ``MeanOut`` and
    ``VarianceOut`` name the same vars as its ``Mean`` and ``Variance``."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    channel_num = input_shape[1] if data_layout == "NCHW" \
        else input_shape[-1]
    param_shape = [channel_num]

    scale = helper.create_parameter(
        attr=helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    from .. import unique_name
    mean = helper.create_global_variable(
        name=moving_mean_name or unique_name.generate(
            helper.name + ".w_mean"),
        dtype=dtype, shape=param_shape, persistable=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name or unique_name.generate(
            helper.name + ".w_variance"),
        dtype=dtype, shape=param_shape, persistable=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))

    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input_shape
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    param_shape = [int(np.prod(input_shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input_shape
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    mask.shape = x.shape
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        out.shape = tuple(input.shape[:-1]) + (1,)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    softmax_out.shape = logits.shape
    loss = helper.create_variable_for_type_inference(logits.dtype)
    if logits.shape:
        loss.shape = tuple(logits.shape[:-1]) + (1,)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (1,)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape and y.shape:
        out.shape = tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:])
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape and y.shape:
        xs = list(x.shape)
        ys = list(y.shape)
        if transpose_x and len(xs) >= 2:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) >= 2:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        if len(xs) >= 2 and len(ys) >= 2:
            out.shape = tuple(xs[:-1]) + (ys[-1],)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def _binary_layer(op_type):
    """``x <op> y`` with Paddle's broadcast: y's dims align to x's starting
    at ``axis`` (-1 = trailing alignment)."""
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_pow = _binary_layer("elementwise_pow")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        s = list(input.shape)
        dims = dim if dim is not None else list(range(len(s)))
        if isinstance(dims, int):
            dims = [dims]
        dims = [d % len(s) for d in dims]
        if keep_dim:
            ns = [1 if i in dims else v for i, v in enumerate(s)]
        else:
            ns = [v for i, v in enumerate(s) if i not in dims]
        out.shape = tuple(ns) if ns else (1,)
    helper.append_op(
        type="reduce_sum", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"dim": dim if isinstance(dim, (list, tuple)) or dim is None
               else [dim],
               "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and -1 not in x.shape:
        total = int(np.prod(x.shape))
        s = [x.shape[i] if v == 0 else v for i, v in enumerate(shape)]
        if -1 in s:
            known = int(np.prod([v for v in s if v != -1]))
            s[s.index(-1)] = total // known
        out.shape = tuple(s)
    else:
        out.shape = tuple(shape)
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape[p] for p in perm)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    input_shape = input.shape
    dim_ = dim % len(input_shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        sizes = ([input_shape[dim_] // num] * num
                 if input_shape[dim_] not in (-1, None) else [-1] * num)
    else:
        sections = list(num_or_sections)
        num = 0
        sizes = sections
    outs = []
    for sz in sizes:
        o = helper.create_variable_for_type_inference(input.dtype)
        s = list(input_shape)
        s[dim_] = sz
        o.shape = tuple(s)
        outs.append(o)
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim_})
    return outs


def gather(input, index):
    helper = LayerHelper("gather", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and index.shape is not None:
        out.shape = (index.shape[0],) + tuple(input.shape[1:])
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        s = list(input.shape)
        for a, st, e in zip(axes, starts, ends):
            if s[a] in (-1, None):
                continue
            st_ = st + s[a] if st < 0 else min(st, s[a])
            e_ = e + s[a] if e < 0 else min(e, s[a])
            s[a] = max(e_ - st_, 0)
        out.shape = tuple(s)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    if input.shape is not None:
        s = tuple(input.shape[:-1]) + (k,)
        values.shape = s
        indices.shape = s
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    return values, indices


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference("float32")
    if input.shape is not None:
        s = list(input.shape)
        if s and s[-1] == 1:
            s = s[:-1]
        out.shape = tuple(s) + (depth,)
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """``(1 − ε) · label + ε / n_classes``: a builder over ``scale``, not
    an op of its own."""
    if epsilon > 1.0 or epsilon < 0.0:
        raise ValueError("epsilon must be in [0, 1]")
    n_classes = label.shape[-1]
    smoothed = scale(label, scale=1.0 - epsilon,
                     bias=epsilon / n_classes if prior_dist is None else 0.0)
    if prior_dist is not None:
        smoothed = elementwise_add(smoothed, scale(prior_dist, scale=epsilon))
    return smoothed


def ring_attention(q, k, v, causal=False, scale=None, sp_axis="sp",
                   bias=None, flash=None, name=None):
    """Fused attention over q, k, v ``[B, H, T, D]`` (ops/attention_ops.py):
    single-device the executor runs the flash kernels
    (ops/flash_attention.py) or the plain full-softmax attention; the
    sequence-parallel ring over an ``sp`` axis comes with the multi-GPU
    slice.  ``bias``, if given, is an additive ``[B, 1, 1, T]`` key bias
    (padding mask).  ``flash``: True forces the flash kernels, False
    forbids them, None (default) = auto (on for CUDA tensors)."""
    helper = LayerHelper("ring_attention", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype("q"))
    out.shape = tuple(q.shape)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op(
        type="ring_attention", inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": causal, "scale": float(scale or 0.0),
               "sp_axis": sp_axis,
               "flash": -1 if flash is None else int(bool(flash))})
    return out


def paged_attention(q, cache_k, cache_v, page_table, bias, scale=1.0,
                    fused=None, name=None):
    """One decode step of attention over a PAGED K/V cache (ops/decode_ops.py,
    ops/paged_attention.py).  q: [slots, 1, d_model]; cache_k/cache_v:
    [num_pages + 1, page_size, d_model] page pools (the last row is the
    trash page); page_table: [slots, pages_per_slot] int; bias: [slots, 1,
    pages_per_slot * page_size] additive validity bias with exact ``-inf``
    past each slot's live length.  ``fused`` is kept in the IR for equality
    with the reference; the port picks kernel or plain version by the
    tensors' device.  Returns [slots, 1, d_model]."""
    helper = LayerHelper("paged_attention", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype("q"))
    out.shape = tuple(q.shape)
    helper.append_op(
        type="paged_attention",
        inputs={"Q": [q], "CacheK": [cache_k], "CacheV": [cache_v],
                "PageTable": [page_table], "Bias": [bias]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale),
               "fused": -1 if fused is None else int(bool(fused))})
    return out


def kv_cache_update(cache, new, slots, pos, name=None):
    """Scatter ``new`` [n, w, ...] into rows of the persistable KV cache
    ``cache`` [rows, width, ...]: row j lands at ``cache[slots[j],
    pos[j]:pos[j]+w]``.  The op's output IS ``cache`` (the port's executor
    updates the scope tensor in place).  Returns ``cache``."""
    helper = LayerHelper("kv_cache_update", **locals())
    helper.append_op(
        type="kv_cache_update",
        inputs={"Cache": [cache], "New": [new], "Slots": [slots],
                "Pos": [pos]},
        outputs={"Out": [cache]})
    return cache


def kv_cache_scatter(cache, new, rows, offs, name=None):
    """Scatter per-token K/V rows ``new`` [n, ...] into the persistable
    cache ``cache`` [rows, width, ...]: token j lands at ``cache[rows[j],
    offs[j]]`` (the speculative verify step).  Dense caches pass (slot,
    absolute position), paged caches (page, in-page offset); a row outside
    the cache writes nothing (the dense trash slot).  The op's output IS
    ``cache``, updated in place.  Returns ``cache``."""
    helper = LayerHelper("kv_cache_scatter", **locals())
    helper.append_op(
        type="kv_cache_scatter",
        inputs={"Cache": [cache], "New": [new], "Rows": [rows],
                "Offs": [offs]},
        outputs={"Out": [cache]})
    return cache


def spec_accept(logits, draft, mask=None, end_id=0, name=None):
    """Greedy speculative acceptance: given verify logits [slots, k+1,
    vocab] and the k drafted tokens [slots, k], return ``(tokens,
    num_accept)``: tokens [slots, k+1] int64, the argmax at every scored
    position; num_accept [slots] int64, the longest draft == argmax prefix.
    Inactive slots (mask == 0) emit ``end_id`` and accept 0."""
    helper = LayerHelper("spec_accept", **locals())
    toks = helper.create_variable_for_type_inference(
        core.convert_dtype("int64"), stop_gradient=True)
    toks.shape = tuple(logits.shape[:-1])
    nacc = helper.create_variable_for_type_inference(
        core.convert_dtype("int64"), stop_gradient=True)
    nacc.shape = (logits.shape[0],)
    inputs = {"Logits": [logits], "Draft": [draft]}
    if mask is not None:
        inputs["Mask"] = [mask]
    helper.append_op(type="spec_accept", inputs=inputs,
                     outputs={"Tokens": [toks], "NumAccept": [nacc]},
                     attrs={"end_id": int(end_id)})
    return toks, nacc


def token_select(logits, mask=None, end_id=0, name=None):
    """Greedy per-slot next token: ``argmax(logits, -1)`` where ``mask`` is
    truthy, ``end_id`` otherwise.  logits: [slots, vocab]; mask: optional
    [slots].  Returns [slots] int64."""
    helper = LayerHelper("token_select", **locals())
    out = helper.create_variable_for_type_inference(
        core.convert_dtype("int64"), stop_gradient=True)
    out.shape = tuple(logits.shape[:-1])
    inputs = {"Logits": [logits]}
    if mask is not None:
        inputs["Mask"] = [mask]
    helper.append_op(type="token_select", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"end_id": int(end_id)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 ``[1]`` counter (``@STEP_COUNTER@`` unless
    named) that starts at ``begin - 1`` and that an ``increment`` op in the
    main program advances by ``step`` every run, before its readers."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True)
    helper.set_variable_initializer(counter,
                                    ConstantInitializer(begin - 1))
    helper.main_program.global_block().append_op(
        type="increment", inputs={"X": [counter]}, outputs={"Out": [counter]},
        attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter
