"""Tensor-construction layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``): the builders the decode and
training programs call, ``reverse``, ``argmin`` / ``argmax`` /
``argsort`` and the finiteness checks."""

from __future__ import annotations

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "reverse",
           "argmin", "argmax", "argsort", "has_inf", "has_nan", "isfinite"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input, name=name)
    out = helper.create_variable_for_type_inference(dtype=helper.input_dtype())
    xs = helper.multiple_input()
    if all(v.shape is not None for v in xs):
        shape = list(xs[0].shape)
        ax = axis % len(shape)
        tot = 0
        for v in xs:
            d = v.shape[ax]
            tot = -1 if (d in (-1, None) or tot == -1) else tot + d
        shape[ax] = tot
        out.shape = tuple(shape)
    helper.append_op(type="concat", inputs={"X": xs},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", input=input)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
        out.shape = helper.multiple_input()[0].shape
    helper.append_op(type="sum", inputs={"X": helper.multiple_input()},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """A Variable's copy (the ``assign`` op) or a numpy constant (an
    ``assign_value`` op)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            output.shape = input.shape
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=core.convert_dtype(input.dtype))
            output.shape = tuple(input.shape)
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(input.shape),
                   "dtype": core.convert_dtype(input.dtype),
                   "fp32_values": [float(v) for v in input.flat]})
    else:
        raise TypeError("assign expects a Variable or numpy array")
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


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    if isinstance(axis, int):
        axis = [axis]
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="reverse", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def _arg_op(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    if x.shape is not None:
        s = list(x.shape)
        del s[axis % len(s)]
        out.shape = tuple(s)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    return _arg_op("arg_min", x, axis)


def argmax(x, axis=0):
    return _arg_op("arg_max", x, axis)


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    out.shape = input.shape
    ids.shape = input.shape
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def _bool_reduce(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="bool",
                                                    stop_gradient=True)
    out.shape = (1,)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def isfinite(x):
    """True iff every element is finite."""
    return _bool_reduce("isfinite", x)


def has_inf(x):
    """True iff any element is +-inf."""
    return _bool_reduce("has_inf", x)


def has_nan(x):
    """True iff any element is NaN."""
    return _bool_reduce("has_nan", x)
