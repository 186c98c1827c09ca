"""Metric ops (counterpart of ``paddle_tpu/ops/metric_ops.py``): accuracy,
the streaming ``auc``, ``mean_iou``, ``positive_negative_pair`` and
``precision_recall``.  Each computes on the device its inputs lie on, as
the reference's ``jnp`` does (no host read)."""

from __future__ import annotations

import torch

from . import collectives
from .registry import register_op


@register_op("accuracy", no_grad_inputs=("Out", "Indices", "Label"))
def accuracy(ctx):
    """Share of rows whose label is among the top-k ``Indices [N, k]``;
    ``Correct`` and ``Total`` are int32 ``[1]``, ``Accuracy`` float32
    ``[1]``; in a data-parallel step, over every rank's rows."""
    indices, label = ctx.input("Indices"), ctx.input("Label")
    if label.dim() == 2:
        label = label.reshape(-1)
    hit = (indices == label[:, None].to(indices.dtype)).any(dim=1)
    correct = hit.sum(dtype=torch.int32)
    # a fill, not a copy from the host: a CUDA graph can capture it
    total = torch.full((), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    group = collectives.batch_group()
    if group is not None:
        # every rank's rows: one all-reduce of both counts
        both = group.all_reduce_(torch.stack([correct, total]))
        correct, total = both[0], both[1]
    acc = correct.to(torch.float32) / total.to(torch.float32)
    return {"Accuracy": acc.reshape(1), "Correct": correct.reshape(1),
            "Total": total.reshape(1)}


@register_op("auc", no_grad_inputs=("Predict", "Label", "StatPos", "StatNeg"))
def auc(ctx):
    """Streaming ROC AUC over ``num_thresholds + 1`` histogram buckets: the
    positive-class probability ``Predict[:, -1]`` picks a bucket
    (truncated, clipped), ``StatPos`` / ``StatNeg`` count positives and
    negatives per bucket IN PLACE (``StatPosOut`` / ``StatNegOut`` are
    the same tensors: adding 1.0 stays exact and order-free up to 2^24 a
    bucket), and the AUC is the trapezoid over the cumulative counts from
    the highest bucket down, 0 until both classes were seen."""
    predict = ctx.input("Predict")
    label = ctx.input("Label").reshape(-1)
    stat_pos, stat_neg = ctx.input("StatPos"), ctx.input("StatNeg")
    n = int(ctx.attr("num_thresholds", 4095))
    bucket = (predict[:, -1] * n).to(torch.int64).clamp(0, n)
    is_pos = label > 0
    stat_pos.index_add_(0, bucket, is_pos.to(stat_pos.dtype))
    stat_neg.index_add_(0, bucket, (~is_pos).to(stat_neg.dtype))
    pos_cum = torch.cumsum(stat_pos.flip(0), 0)
    neg_cum = torch.cumsum(stat_neg.flip(0), 0)
    prev_pos = torch.cat([pos_cum.new_zeros(1), pos_cum[:-1]])
    prev_neg = torch.cat([neg_cum.new_zeros(1), neg_cum[:-1]])
    area = ((neg_cum - prev_neg) * (pos_cum + prev_pos) / 2.0).sum()
    tot_pos, tot_neg = pos_cum[-1], neg_cum[-1]
    value = torch.where((tot_pos > 0) & (tot_neg > 0),
                        area / torch.clamp_min(tot_pos * tot_neg, 1e-12),
                        torch.zeros_like(area))
    return {"AUC": value.reshape(1), "StatPosOut": stat_pos,
            "StatNegOut": stat_neg}


@register_op("mean_iou", no_grad_inputs=("Predictions", "Labels"))
def mean_iou(ctx):
    """Mean intersection over union of ``num_classes`` classes from a
    float32 confusion matrix (labels by rows, predictions by columns):
    ``OutMeanIou [1]`` over the classes that occur in either,
    ``OutWrong`` / ``OutCorrect [num_classes]``."""
    pred = ctx.input("Predictions").reshape(-1).to(torch.int64)
    label = ctx.input("Labels").reshape(-1).to(torch.int64)
    n = int(ctx.attr("num_classes"))
    conf = torch.zeros(n * n, dtype=torch.float32, device=pred.device)
    conf.index_add_(0, label * n + pred,
                    torch.ones(pred.shape, dtype=torch.float32,
                               device=pred.device))
    conf = conf.reshape(n, n)
    inter = torch.diagonal(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1e-12),
                      torch.zeros_like(union))
    miou = iou.sum() / torch.clamp_min(valid.to(torch.float32).sum(), 1.0)
    return {"OutMeanIou": miou.reshape(1), "OutWrong": conf.sum(1) - inter,
            "OutCorrect": inter}


@register_op("positive_negative_pair",
             no_grad_inputs=("Score", "Label", "QueryID", "Weight",
                             "AccumulatePositivePair",
                             "AccumulateNegativePair",
                             "AccumulateNeutralPair"))
def positive_negative_pair(ctx):
    """Ranking pairs within each query: every pair of documents with
    different labels counts as positive when the scores (column
    ``column``) order them as the labels do, else negative; an equal
    score counts as neutral and negative.  A pair weighs the mean of its
    two ``Weight``s (1 without).  The ``Accumulate*`` inputs add on."""
    score = ctx.input("Score")
    label = ctx.input("Label").reshape(-1).to(torch.float32)
    query = ctx.input("QueryID").reshape(-1)
    s = score[:, int(ctx.attr("column", 0))].to(torch.float32)
    w_in = ctx.input("Weight")
    w = w_in.reshape(-1).to(torch.float32) if w_in is not None \
        else torch.ones_like(s)
    n = s.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=s.device).triu(diagonal=1)
    pair = (query[:, None] == query[None, :]) & upper \
        & (label[:, None] != label[None, :])
    pw = (w[:, None] + w[None, :]) * 0.5
    ds = s[:, None] - s[None, :]
    agree = ds * (label[:, None] - label[None, :]) > 0
    zero = torch.zeros_like(pw)
    neu = torch.where(pair & (ds == 0), pw, zero).sum()
    pos = torch.where(pair & agree, pw, zero).sum()
    neg = torch.where(pair & ~agree, pw, zero).sum()
    out = {}
    for slot, acc_slot, v in (
            ("PositivePair", "AccumulatePositivePair", pos),
            ("NegativePair", "AccumulateNegativePair", neg),
            ("NeutralPair", "AccumulateNeutralPair", neu)):
        acc = ctx.input(acc_slot)
        out[slot] = (v + acc.reshape(-1)[0] if acc is not None
                     else v).reshape(1)
    return out


def _pr_metrics(states):
    """[macro P, macro R, macro F1, micro P, micro R, micro F1] of
    per-class ``[TP, FP, TN, FN]`` states; a class with no prediction or
    no label counts precision or recall 1, and F1 is 0 at P + R = 0.
    Macro F1 is F1 of the macro P and R."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    one = torch.ones_like(tp)

    def ratio(num, den, default):
        return torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                           default)

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / torch.clamp_min(
            p + r, 1e-12), torch.zeros_like(p))

    macro_p = ratio(tp, tp + fp, one).mean()
    macro_r = ratio(tp, tp + fn, one).mean()
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    one = torch.ones_like(stp)
    micro_p, micro_r = ratio(stp, stp + sfp, one), ratio(stp, stp + sfn, one)
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r), micro_p,
                        micro_r, f1(micro_p, micro_r)])


@register_op("precision_recall",
             no_grad_inputs=("MaxProbs", "Indices", "Labels", "Weights",
                             "StatesInfo"))
def precision_recall(ctx):
    """Multi-class precision, recall and F1 of the predicted class
    ``Indices`` against ``Labels``: per-class ``[TP, FP, TN, FN]`` states
    (weighted by ``Weights``), float64 ``BatchMetrics`` of this batch and
    ``AccumMetrics`` of the states accumulated with ``StatesInfo``
    (``AccumStatesInfo``, float32)."""
    idx = ctx.input("Indices").reshape(-1).to(torch.int64)
    label = ctx.input("Labels").reshape(-1).to(torch.int64)
    cls = int(ctx.attr("class_number"))
    w_in = ctx.input("Weights")
    w = w_in.reshape(-1).to(torch.float32) if w_in is not None \
        else torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    oh_idx = torch.nn.functional.one_hot(idx, cls).to(torch.float32)
    oh_lab = torch.nn.functional.one_hot(label, cls).to(torch.float32)
    hit = (idx == label)[:, None]
    wv, zero = w[:, None], torch.zeros_like(oh_idx)
    tp = torch.where(hit, oh_idx * wv, zero).sum(0)
    fp = torch.where(~hit, oh_idx * wv, zero).sum(0)
    fn = torch.where(~hit, oh_lab * wv, zero).sum(0)
    tn = w.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)
    prev = ctx.input("StatesInfo")
    accum = batch_states + prev.to(torch.float32) if prev is not None \
        else batch_states
    return {"BatchMetrics": _pr_metrics(batch_states).to(torch.float64),
            "AccumMetrics": _pr_metrics(accum).to(torch.float64),
            "AccumStatesInfo": accum}
