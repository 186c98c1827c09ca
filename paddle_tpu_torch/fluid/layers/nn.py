"""NN layers (counterpart of ``paddle_tpu/fluid/layers/nn.py``): the builders
the decode and training programs call, copied so the same calls emit the
same IR."""

from __future__ import annotations

import numpy as np

from .. import core
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "softmax",
    "softmax_with_cross_entropy", "mul", "matmul", "elementwise_add",
    "elementwise_mul", "elementwise_div", "scale", "reduce_sum", "reshape",
    "transpose", "one_hot", "label_smooth", "kv_cache_update",
    "paged_attention", "token_select",
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
    if len(mul_results) != 1:
        raise NotImplementedError("fc over several inputs needs the sum op, "
                                  "not ported yet")
    pre_act = helper.append_bias_op(mul_results[0],
                                    dim_start=num_flatten_dims)
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
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")


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
