"""Activation and logical layer wrappers (counterpart of
``paddle_tpu/fluid/layers/ops.py``; only ``relu`` and ``logical_not`` are
on the port's path)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["relu", "logical_not"]


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool")
        out.shape = x.shape
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
