"""Activation layer wrappers (counterpart of
``paddle_tpu/fluid/layers/ops.py``; only ``relu`` is on this slice's path)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["relu"]


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out
