"""Layer-function generation helpers (counterpart of
``paddle_tpu/fluid/layers/layer_function_generator.py``): the reference's
upstream generated layer wrappers from C++ op protos; here the op
registry is the source, so ``generate_layer_fn`` builds a wrapper for an
op type the port's registry holds."""

from __future__ import annotations

import functools
import warnings

from ..layer_helper import LayerHelper

__all__ = ["generate_layer_fn", "autodoc", "templatedoc", "deprecated"]


def generate_layer_fn(op_type: str, input_slot: str = "X",
                      output_slot: str = "Out"):
    """A one-input, one-output layer for a registered op: it appends the
    op with the keyword arguments as attrs.  The output keeps the input's
    static shape for the unary elementwise ops of ``layers.ops``; for
    any other op it is left unset."""
    from ...ops.registry import is_registered

    if not is_registered(op_type):
        raise ValueError(f"op {op_type!r} is not registered")

    from .ops import _UNARY_ATTR_OPS, _UNARY_OPS

    shape_preserving = op_type in _UNARY_OPS or op_type in _UNARY_ATTR_OPS

    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        if shape_preserving:
            out.shape = tuple(x.shape)
        helper.append_op(type=op_type, inputs={input_slot: [x]},
                         outputs={output_slot: [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Auto-generated wrapper for the `{op_type}` op."
    return layer


def autodoc(comment=""):
    """Prefix ``comment`` to the decorated function's docstring."""
    def deco(func):
        func.__doc__ = (comment + "\n" + (func.__doc__ or "")).strip()
        return func
    return deco


def templatedoc(op_type=None):
    """Fill ``${comment}`` in the docstring with ``op_type`` (there are no
    op protos to draw a comment from)."""
    def deco(func):
        if op_type and func.__doc__:
            func.__doc__ = func.__doc__.replace("${comment}", op_type)
        return func
    return deco


def deprecated(since="", instead=""):
    """Mark a layer deprecated: each call warns (``DeprecationWarning``)."""
    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(
                f"{func.__name__} is deprecated"
                + (f" since {since}" if since else "")
                + (f"; use {instead} instead" if instead else ""),
                DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)
        return wrapper
    return deco
