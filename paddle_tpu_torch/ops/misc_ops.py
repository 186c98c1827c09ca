"""Misc ops (counterpart of ``paddle_tpu/ops/misc_ops.py``): of that module
the port holds ``depthwise_conv2d_transpose``, the transposed
convolution whose ``groups`` default to the input's channel count (as
``depthwise_conv2d``'s do), with an explicit grad."""

from __future__ import annotations

from .nn_ops import _convolution, _convolution_grad
from .registry import register_grad, register_op


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ctx):
    return _convolution(ctx, 2, True, depthwise=True)


@register_grad("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose_grad(ctx):
    return _convolution_grad(ctx, 2, True, depthwise=True)
