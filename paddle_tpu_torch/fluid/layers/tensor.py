"""Tensor-construction layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``): the builders the decode and
training programs call."""

from __future__ import annotations

import numpy as np

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "create_global_var", "cast", "assign",
           "fill_constant", "fill_constant_batch_size_like"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import ConstantInitializer

    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=helper.name if name is None else name,
                                        dtype=dtype, shape=shape,
                                        persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = core.convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        dtype=core.convert_dtype(dtype))
    s = list(shape)
    s[output_dim_idx] = -1
    out.shape = tuple(s)
    out.stop_gradient = True
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": core.convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out
