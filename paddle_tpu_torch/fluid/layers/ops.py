"""Activation and logical layer wrappers (counterpart of
``paddle_tpu/fluid/layers/ops.py``): ``relu``, ``sigmoid``, ``tanh``,
``square``, the unary ops of the learning-rate schedules (``exp``,
``floor``, ``ceil``, ``cos``), ``log`` and the logical ops."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = ["relu", "sigmoid", "tanh", "square", "exp", "floor", "ceil",
              "cos", "log"]

__all__ = list(_UNARY_OPS) + ["logical_and", "logical_or", "logical_xor",
                              "logical_not"]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={})
        return out

    layer.__name__ = op_type
    return layer


for _name in _UNARY_OPS:
    globals()[_name] = _make_unary(_name)


def _make_logical(op_type):
    binary = op_type != "logical_not"

    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(dtype="bool")
            # static shape = the broadcast of both operands
            shp = x.shape
            if binary and y is not None and y.shape is not None:
                if shp is None or len(y.shape) > len(shp):
                    shp = y.shape
            out.shape = shp
        inputs = {"X": [x]}
        if binary:
            inputs["Y"] = [y]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


logical_and = _make_logical("logical_and")
logical_or = _make_logical("logical_or")
logical_xor = _make_logical("logical_xor")
logical_not = _make_logical("logical_not")
