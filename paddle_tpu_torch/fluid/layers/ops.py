"""Activation, logical and generator layer wrappers (counterpart of
``paddle_tpu/fluid/layers/ops.py``): every unary activation of the
reference (an attr-taking one with the reference's defaults, overridden
by keyword), the logical ops, ``uniform_random`` and ``cumsum``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "log", "square", "softplus", "softsign", "relu",
    "soft_relu", "gelu", "log_softmax",
]

_UNARY_ATTR_OPS = {
    "relu6": {"threshold": 6.0},
    "leaky_relu": {"alpha": 0.02},
    "elu": {"alpha": 1.0},
    "pow": {"factor": 1.0},
    "stanh": {"scale_a": 0.67, "scale_b": 1.7159},
    "hard_sigmoid": {"slope": 0.2, "offset": 0.5},
    "hard_shrink": {"threshold": 0.5},
    "thresholded_relu": {"threshold": 1.0},
    "brelu": {"t_min": 0.0, "t_max": 24.0},
    "swish": {"beta": 1.0},
}

__all__ = list(_UNARY_OPS) + list(_UNARY_ATTR_OPS) + [
    "uniform_random", "cumsum",
    "logical_and", "logical_or", "logical_xor", "logical_not",
]


def _make_unary(op_type, default_attrs=None):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        attrs = dict(default_attrs or {})
        for k in attrs:
            if k in kwargs:
                attrs[k] = kwargs[k]
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} activation (see ops/activation_ops.py)"
    return layer


for _name in _UNARY_OPS:
    globals()[_name] = _make_unary(_name)
for _name, _attrs in _UNARY_ATTR_OPS.items():
    globals()[_name] = _make_unary(_name, _attrs)


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


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = tuple(shape)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out
