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
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}
