"""Operators on ``Variable`` (counterpart of
``paddle_tpu/fluid/layers/math_op_patch.py``): ``+ - * / **``, their
reflected forms, unary ``-`` and the comparisons ``< <= > >=`` append the
reference's ops.  A python scalar with ``+ - *`` or ``/`` by a scalar
becomes one ``scale`` op; otherwise it becomes a ``[1]`` ``fill_constant``
in the Variable's dtype and the elementwise or compare op takes it."""

from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper


def _create_op(op_type, x, y, axis=-1, out_dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def _scalar_op(x, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": True})
    return out


def _to_var(x, ref):
    """A python scalar as a ``[1]`` filled tensor in ``ref``'s dtype."""
    from . import tensor as _tensor

    if isinstance(x, Variable):
        return x
    return _tensor.fill_constant(shape=[1], dtype=ref.dtype, value=float(x))


def _binary(op_type, reverse=False):
    def impl(self, other):
        if isinstance(other, (int, float)):
            if op_type == "elementwise_add":
                return _scalar_op(self, 1.0, other)
            if op_type == "elementwise_sub":
                if reverse:
                    return _scalar_op(self, -1.0, other)
                return _scalar_op(self, 1.0, -other)
            if op_type == "elementwise_mul":
                return _scalar_op(self, other, 0.0)
            if op_type == "elementwise_div" and not reverse:
                return _scalar_op(self, 1.0 / other, 0.0)
            other = _to_var(other, self)
        x, y = (other, self) if reverse else (self, other)
        if not isinstance(x, Variable):
            x = _to_var(x, self)
        return _create_op(op_type, x, y)

    return impl


def _compare(op_type):
    def impl(self, other):
        other = _to_var(other, self)
        return _create_op(op_type, self, other, out_dtype="bool")

    return impl


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add")
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul")
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__div__ = Variable.__truediv__
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__rpow__ = _binary("elementwise_pow", reverse=True)
    Variable.__lt__ = _compare("less_than")
    Variable.__le__ = _compare("less_equal")
    Variable.__gt__ = _compare("greater_than")
    Variable.__ge__ = _compare("greater_equal")
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
