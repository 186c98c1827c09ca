"""Sequence and recurrent layers (counterpart of
``paddle_tpu/fluid/layers/sequence.py``): the builders of the sequence
(LoD) ops, of the recurrent ops and of the beam ops, emitting the
reference's ops call for call.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit", "lstm_unit",
    "sequence_conv", "sequence_pool", "sequence_softmax", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad", "sequence_slice",
    "sequence_reshape", "sequence_enumerate", "sequence_mask",
    "sequence_reverse", "row_conv", "beam_search", "beam_search_decode",
]


def _out(helper, dtype, shape=None):
    v = helper.create_variable_for_type_inference(dtype=dtype)
    if shape is not None:
        v.shape = tuple(shape)
    return v


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """``input`` is the 4*hidden projection (apply fc first); ``size`` is
    4*hidden."""
    helper = LayerHelper("dynamic_lstm", **locals())
    d = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[d, 4 * d], dtype=dtype)
    bias_size = [1, 7 * d] if use_peepholes else [1, 4 * d]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = _out(helper, dtype, (input.shape[0], d))
    cell = _out(helper, dtype, (input.shape[0], d))
    batch_gate = _out(helper, dtype)
    batch_cell_pre_act = _out(helper, dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="dynamic_lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre_act]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection."""
    helper = LayerHelper("dynamic_lstmp", **locals())
    d = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[proj_size, 4 * d], dtype=dtype)
    proj_weight = helper.create_parameter(attr=helper.param_attr,
                                          shape=[d, proj_size], dtype=dtype)
    bias_size = [1, 7 * d] if use_peepholes else [1, 4 * d]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    projection = _out(helper, dtype, (input.shape[0], proj_size))
    cell = _out(helper, dtype, (input.shape[0], d))
    helper.append_op(
        type="dynamic_lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [projection], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    """``input`` is the 3*size projection."""
    helper = LayerHelper("dynamic_gru", **locals())
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = _out(helper, dtype, (input.shape[0], size))
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="dynamic_gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation,
               "origin_mode": origin_mode})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step; returns
    (hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    d = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[d, 3 * d], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * d],
                                   dtype=dtype, is_bias=True)
    act_enum = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
    gate = _out(helper, dtype)
    reset_hidden_prev = _out(helper, dtype)
    updated_hidden = _out(helper, dtype, (input.shape[0], d))
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_prev],
                 "Hidden": [updated_hidden]},
        attrs={"activation": act_enum[activation],
               "gate_activation": act_enum[gate_activation]})
    return updated_hidden, reset_hidden_prev, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """fc([x_t, h_prev]) -> the lstm_unit op;
    returns (hidden, cell)."""
    from .nn import fc
    from .tensor import concat

    helper = LayerHelper("lstm_unit", **locals())
    size = cell_t_prev.shape[-1]
    cat = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(cat, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    dtype = x_t.dtype
    c = _out(helper, dtype, cell_t_prev.shape)
    h = _out(helper, dtype, hidden_t_prev.shape)
    helper.append_op(
        type="lstm_unit", inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = _out(helper, dtype, (input.shape[0], num_filters))
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool", **locals())
    dtype = helper.input_dtype()
    pool_out = _out(helper, dtype, (-1,) + tuple(input.shape[1:]))
    max_index = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="sequence_pool", inputs={"X": [input]},
        outputs={"Out": [pool_out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    if pool_type == "max":
        max_index.stop_gradient = True
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = _out(helper, input.dtype, input.shape)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = _out(helper, inputs[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(inputs)},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    # rows are dynamic (expansion counts come from y's LoD) but trailing
    # dims survive — downstream fc/shape math needs them
    out = _out(helper, x.dtype,
               shape=((-1,) + tuple(x.shape[1:])) if x.shape else None)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", **locals())
    out = _out(helper, x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", **locals())
    out = _out(helper, x.dtype)
    length = helper.create_variable_for_type_inference(dtype="int64")
    length.stop_gradient = True
    helper.append_op(
        type="sequence_pad", inputs={"X": [x], "PadValue": [pad_value]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": -1 if maxlen is None else maxlen})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", **locals())
    out = _out(helper, x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = _out(helper, input.dtype)
    offset.stop_gradient = True
    length.stop_gradient = True
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = _out(helper, input.dtype, (-1, new_dim))
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out.stop_gradient = True
    helper.append_op(type="sequence_enumerate", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.stop_gradient = True
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": -1 if maxlen is None else maxlen,
                            "out_dtype": dtype})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", **locals())
    out = _out(helper, x.dtype, x.shape)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None):
    """ref: layers/nn.py:2780 — one beam-search step (fixed-width beams,
    run on the host: see ops/array_ops.py beam_search)."""
    helper = LayerHelper("beam_search", **locals())
    selected_ids = helper.create_variable_for_type_inference(dtype="int64")
    selected_scores = helper.create_variable_for_type_inference(
        dtype=scores.dtype)
    inputs = {"pre_ids": [pre_ids], "scores": [scores]}
    if pre_scores is not None:
        inputs["pre_scores"] = [pre_scores]
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"selected_ids": [selected_ids],
                 "selected_scores": [selected_scores]},
        attrs={"level": level, "beam_size": beam_size, "end_id": end_id})
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size=None, end_id=None, name=None):
    """ref: layers/nn.py:2892 — backtrack hypotheses from step arrays."""
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_variable_for_type_inference(dtype="int64")
    sentence_scores = helper.create_variable_for_type_inference(
        dtype="float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={"SentenceIds": [sentence_ids],
                 "SentenceScores": [sentence_scores]},
        attrs={"beam_size": beam_size or 0, "end_id": -1 if end_id is None
               else end_id})
    return sentence_ids, sentence_scores


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution."""
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[1]]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = _out(helper, dtype, input.shape)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)
