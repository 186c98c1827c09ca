"""Activation ops (counterpart of ``paddle_tpu/ops/activation_ops.py``):
relu and softmax."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("relu")
def relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


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
