"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``):
softmax_with_cross_entropy."""

from __future__ import annotations

import torch

from . import fused
from .registry import register_op


@register_op("softmax_with_cross_entropy", no_grad_inputs=("Label",))
def softmax_with_cross_entropy(ctx):
    """Logits ``[..., V]`` with hard labels ``[..., 1]`` (int) or soft
    labels ``[..., V]`` -> ``Loss [..., 1]`` (and ``Softmax``).

    The loss goes through :class:`fused.SoftmaxXent`: the CUDA kernels for
    CUDA tensors, their plain versions for CPU tensors, so the grad op
    (the generic grad) reaches the backward kernel.  ``Softmax`` is built
    as ``exp(logits − lse)`` only when some op other than this op's own
    grad, or the caller, reads it (``ctx.outputs_spec``): the reference
    leaves the same expression to XLA's dead-code elimination, and eager
    PyTorch eliminates nothing — on the training path it would be another
    ``[R, V]`` tensor."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    soft = bool(ctx.attr("soft_label", False))
    v = logits.shape[-1]
    lead = tuple(logits.shape[:-1])
    x2 = logits.reshape(-1, v).contiguous()
    lab2 = label.reshape(-1, v).contiguous() if soft else label.reshape(-1)
    loss, lse = fused.SoftmaxXent.apply(x2, lab2, soft,
                                        int(ctx.attr("ignore_index", -100)))
    out = {"Loss": loss.reshape(lead + (1,))}
    if "Softmax" in ctx.outputs_spec:
        out["Softmax"] = torch.exp(logits - lse.reshape(lead + (1,)))
    return out
