"""Comparison layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): ``equal``, the one builder
of that module on the port's path."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["equal"]


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool",
                                                         stop_gradient=True)
        cond.shape = x.shape
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond
