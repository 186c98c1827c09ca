"""Activation ops (counterpart of ``paddle_tpu/ops/activation_ops.py``):
relu, sigmoid, tanh and square (the ``act`` of fc / conv2d layers, the
SE gate, DeepFM's FM term), softmax, and the unary ops the learning-rate
schedules emit (exp, floor, ceil, cos).  Their grads come from the generic
grad; a bf16 / fp16 input stays in its dtype, as in the reference."""

from __future__ import annotations

import torch

from .registry import register_op


def _unary(name, fn):
    @register_op(name)
    def _impl(ctx, _fn=fn):
        return {"Out": _fn(ctx.input("X"))}
    return _impl


_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("square", torch.square)
_unary("exp", torch.exp)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("cos", torch.cos)


@register_op("softmax")
def softmax(ctx):
    """A bf16 / fp16 input is exponentiated and renormalized in fp32 (low
    exponentials lose the tail mass) and the result cast back, so
    attention maps stay low under AMP keep_activations."""
    from ..fluid import amp

    x = ctx.input("X")
    if amp.is_low_float(x.dtype):
        return {"Out": torch.softmax(x.float(), dim=-1).to(x.dtype)}
    return {"Out": torch.softmax(x, dim=-1)}
