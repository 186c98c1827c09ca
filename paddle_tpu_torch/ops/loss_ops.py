"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``): cross_entropy,
softmax_with_cross_entropy and sigmoid_cross_entropy_with_logits."""

from __future__ import annotations

import torch

from . import fused
from .registry import register_op


def _hard_xent(probs, label, ignore_index=-100):
    """``-log(max(probs[label], 1e-20))``, 0 where label == ignore_index
    (≥ 0)."""
    if label.dim() == probs.dim() and label.shape[-1] == 1:
        label = label.reshape(label.shape[:-1])
    li = label.long()
    loss = -torch.log(probs.gather(-1, li[..., None]).clamp_min(1e-20))
    if ignore_index >= 0:
        loss = torch.where((li == ignore_index)[..., None], 0.0, loss)
    return loss


@register_op("cross_entropy", no_grad_inputs=("Label",))
def cross_entropy(ctx):
    """Cross entropy of probabilities ``X [..., C]``: hard labels
    ``[..., 1]`` (int) or soft labels ``[..., C]`` -> ``Y [..., 1]``."""
    from ..fluid import amp

    x, label = ctx.input("X"), ctx.input("Label")
    if amp.is_low_float(x.dtype):
        x = x.float()  # log() at the loss boundary is fp32
    if ctx.attr("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(x.clamp_min(1e-20)), -1,
                                keepdim=True)}
    return {"Y": _hard_xent(x, label, ctx.attr("ignore_index", -100))}


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
    ``[R, V]`` tensor.  Logits in bf16 or fp16 (AMP keep_activations) go
    to the kernels as they are, which compute in fp32; ``Loss`` is fp32
    and ``Softmax`` is ``exp(float32(logits) − lse)`` in the logits'
    dtype, as the reference's ``softmax_xent_op``."""
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
        out["Softmax"] = torch.exp(
            logits.float() - lse.reshape(lead + (1,))).to(logits.dtype)
    return out


@register_op("sigmoid_cross_entropy_with_logits", no_grad_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ctx):
    """Elementwise ``max(x, 0) − x·label + log(1 + exp(−|x|))``, 0 where
    ``label == ignore_index`` (≥ 0): the reference's expression, with its
    type promotion (a bf16 ``x`` against an fp32 label gives an fp32
    loss).  ``torch.maximum`` against zeros splits the grad of a tie as
    ``jnp.maximum`` does."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = ctx.attr("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label == ignore, 0.0, loss)
    return {"Out": loss}
