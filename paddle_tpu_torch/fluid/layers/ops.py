"""Activation and logical layer wrappers (counterpart of
``paddle_tpu/fluid/layers/ops.py``): ``relu``, ``sigmoid``, ``tanh``,
``square``, the unary ops of the learning-rate schedules (``exp``,
``floor``, ``ceil``, ``cos``) and ``logical_not``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = ["relu", "sigmoid", "tanh", "square", "exp", "floor", "ceil",
              "cos"]

__all__ = list(_UNARY_OPS) + ["logical_not"]


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


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool")
        out.shape = x.shape
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
