"""Tensor-construction layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``): the builders the decode programs
call."""

from __future__ import annotations

import numpy as np

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "assign", "fill_constant"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def assign(input, output=None):
    """A numpy constant as an ``assign_value`` op (the Variable-copy form
    of the reference emits the ``assign`` op, not ported yet)."""
    helper = LayerHelper("assign")
    if not isinstance(input, np.ndarray):
        raise TypeError("assign expects a numpy array in this port")
    if output is None:
        output = helper.create_variable_for_type_inference(
            dtype=core.convert_dtype(input.dtype))
        output.shape = tuple(input.shape)
    helper.append_op(
        type="assign_value", outputs={"Out": [output]},
        attrs={"shape": list(input.shape),
               "dtype": core.convert_dtype(input.dtype),
               "fp32_values": [float(v) for v in input.flat]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=core.convert_dtype(dtype))
    out.shape = tuple(shape)
    out.stop_gradient = True
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": core.convert_dtype(dtype),
                            "value": float(value),
                            "force_cpu": bool(force_cpu)})
    return out
