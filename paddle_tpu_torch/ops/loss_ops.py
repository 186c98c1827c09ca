"""Loss ops (counterpart of ``paddle_tpu/ops/loss_ops.py``): cross_entropy,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits, and the
elementwise and pairwise losses huber, smooth-L1, log, hinge, rank,
margin-rank, squared L2 norm and distance, BPR and KL divergence (their
grads come from the generic grad)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    dtype, as the reference's ``softmax_xent_op``.  In a tp step whose
    logits are sharded over the vocabulary the loss goes through
    :class:`fused.SoftmaxXentSharded` (the partials entry and one max /
    sum exchange), and ``Softmax`` is the rank's slice."""
    from . import collectives

    logits, label = ctx.input("Logits"), ctx.input("Label")
    soft = bool(ctx.attr("soft_label", False))
    v = logits.shape[-1]
    lead = tuple(logits.shape[:-1])
    x2 = logits.reshape(-1, v).contiguous()
    lab2 = label.reshape(-1, v).contiguous() if soft else label.reshape(-1)
    ignore = int(ctx.attr("ignore_index", -100))
    group = collectives.shard_group()
    if group is not None:
        # the logits are this rank's vocabulary slice (a tp step,
        # ``parallel/placement.py``); a soft label is sliced with them
        loss, lse = fused.SoftmaxXentSharded.apply(x2, lab2, soft, ignore,
                                                   group)
    else:
        loss, lse = fused.SoftmaxXent.apply(x2, lab2, soft, ignore)
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


@register_op("huber_loss", no_grad_inputs=("Y",))
def huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    d = ctx.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= d, 0.5 * r * r, d * (ar - 0.5 * d))
    return {"Out": loss, "Residual": r}


@register_op("smooth_l1_loss", no_grad_inputs=("Y",))
def smooth_l1_loss(ctx):
    """Per-row sum ``[N, 1]`` of ``0.5 (σ d)^2`` below ``1 / σ^2``, else
    ``|d| - 0.5 / σ^2``, with ``d = (x - y) · InsideWeight`` and the
    terms scaled by ``OutsideWeight``."""
    x, y = ctx.input("X"), ctx.input("Y")
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    iw, ow = ctx.input("InsideWeight"), ctx.input("OutsideWeight")
    d = x - y
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    val = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ow is not None:
        val = val * ow
    return {"Out": val.reshape(val.shape[0], -1).sum(1, keepdim=True),
            "Diff": d}


@register_op("log_loss", no_grad_inputs=("Labels",))
def log_loss(ctx):
    p, y = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": -y * torch.log(p + eps)
            - (1.0 - y) * torch.log(1.0 - p + eps)}


@register_op("hinge_loss", no_grad_inputs=("Labels",))
def hinge_loss(ctx):
    logits, y = ctx.input("Logits"), ctx.input("Labels")
    return {"Loss": torch.clamp_min(1.0 - (2.0 * y - 1.0) * logits, 0.0)}


@register_op("rank_loss", no_grad_inputs=("Label",))
def rank_loss(ctx):
    """RankNet: ``log(1 + exp(left - right)) - label · (left - right)``."""
    label = ctx.input("Label")
    d = ctx.input("Left") - ctx.input("Right")
    return {"Out": torch.log1p(torch.exp(d)) - label * d}


@register_op("margin_rank_loss", no_grad_inputs=("Label",))
def margin_rank_loss(ctx):
    label = ctx.input("Label")
    x1, x2 = ctx.input("X1"), ctx.input("X2")
    out = torch.clamp_min(-label * (x1 - x2) + ctx.attr("margin", 0.0), 0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx):
    x = ctx.input("X")
    return {"Out": torch.sum(x * x).reshape(1)}


@register_op("squared_l2_distance")
def squared_l2_distance(ctx):
    """Per-row ``sum((x - y)^2)`` ``[N, 1]`` (``y`` broadcasts) and the
    difference."""
    d = ctx.input("X") - ctx.input("Y")
    sq = d * d
    if d.dim() > 1:
        sq = sq.sum(tuple(range(1, d.dim())))
    return {"Out": sq.reshape(-1, 1), "sub_result": d}


@register_op("bpr_loss", no_grad_inputs=("Label",))
def bpr_loss(ctx):
    """Bayesian personalized ranking: the mean of ``-log σ(x_label -
    x_j)`` over the C - 1 classes j other than the label."""
    x, label = ctx.input("X"), ctx.input("Label")
    if label.dim() == x.dim() and label.shape[-1] == 1:
        label = label.reshape(label.shape[:-1])
    li = label.long()
    pos = x.gather(-1, li[..., None])
    others = 1.0 - F.one_hot(li, x.shape[-1]).to(x.dtype)
    lls = F.logsigmoid(pos - x)
    return {"Y": -(lls * others).sum(-1, keepdim=True) / (x.shape[-1] - 1)}


@register_op("kldiv_loss", no_grad_inputs=("Target",))
def kldiv_loss(ctx):
    """``target · (log(target) - x)`` of log-probabilities ``x``, reduced
    by ``reduction`` (mean, sum, batchmean or none)."""
    x, t = ctx.input("X"), ctx.input("Target")
    loss = t * (torch.log(t.clamp_min(1e-20)) - x)
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": loss}
