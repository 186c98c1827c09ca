"""Faster R-CNN training ops and mAP (counterpart of
``paddle_tpu/ops/rcnn_ops.py``): ``generate_proposals``,
``rpn_target_assign``, ``generate_proposal_labels`` and
``detection_map``.

All four are host ops (``registry.EAGER_OPS``), as in the reference:
each reads its inputs off the device in one transfer
(``detection_ops.to_host``, counted in ``detection_ops.stats``), runs the
reference's numpy algorithm, and returns its outputs as tensors on the
input's device.  A later reader of those outputs (``roi_pool`` reading
the sampled RoIs, ``detection_map`` its fed-back accumulators) reads them
off the device again, so an in-place write to one is always seen.

The samplers draw from numpy as the reference's do (:func:`_op_rng`): a
nonzero ``seed`` attr gives ``RandomState(seed + n)`` for the module's
``n``-th sampler call, so seeded runs of both packages draw the same
samples when both counters start together.
"""

from __future__ import annotations

import numpy as np

from .detection_ops import _segments, to_device, to_host
from .registry import register_grad, register_op

LOG_MAX_RATIO = float(np.log(1000.0 / 16.0))


def _np_iou(a, b):
    """IoU with +1 widths (pixel boxes), in float32 numpy."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2]) -
                    np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0)
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3]) -
                    np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0)
    inter = iw * ih
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _decode_anchors(anchors, deltas, variances):
    """Anchor deltas to boxes (+1 widths, the log-ratio clipped)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    if variances is not None:
        dx, dy = variances[:, 0] * deltas[:, 0], variances[:, 1] * deltas[:, 1]
        dw = np.minimum(variances[:, 2] * deltas[:, 2], LOG_MAX_RATIO)
        dh = np.minimum(variances[:, 3] * deltas[:, 3], LOG_MAX_RATIO)
    else:
        dx, dy = deltas[:, 0], deltas[:, 1]
        dw = np.minimum(deltas[:, 2], LOG_MAX_RATIO)
        dh = np.minimum(deltas[:, 3], LOG_MAX_RATIO)
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = np.exp(dw) * aw
    h = np.exp(dh) * ah
    return np.stack([cx - w / 2, cy - h / 2,
                     cx + w / 2 - 1, cy + h / 2 - 1], axis=1)


def _nms_plain(boxes, scores, thresh, top_n, eta=1.0):
    order = np.argsort(-scores)
    keep = []
    adaptive = thresh
    while order.size and (top_n < 0 or len(keep) < top_n):
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _np_iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= adaptive]
        if eta < 1 and adaptive > 0.5:
            adaptive *= eta
    return np.asarray(keep, np.int64)


def _device(ctx, slot):
    return ctx.input(slot).device


@register_op("generate_proposals", no_grad_inputs=("Scores", "BboxDeltas",
                                                   "ImInfo", "Anchors",
                                                   "Variances"))
def generate_proposals(ctx):
    """RPN outputs to proposals, per image: decode the ``pre_nms_topN``
    best anchors, clip to the image, drop boxes under ``min_size``, NMS to
    ``post_nms_topN``; ``RpnRois [R, 4]`` and ``RpnRoiProbs [R, 1]`` with
    one LoD segment an image."""
    scores, deltas, im_info, anchors, variances = to_host(
        *(ctx.input(s) for s in ("Scores", "BboxDeltas", "ImInfo",
                                 "Anchors", "Variances")))
    anchors = anchors.reshape(-1, 4)
    variances = variances.reshape(-1, 4) if variances is not None else None
    pre_n = ctx.attr("pre_nms_topN", 6000)
    post_n = ctx.attr("post_nms_topN", 1000)
    nms_thresh = ctx.attr("nms_thresh", 0.5)
    min_size = ctx.attr("min_size", 0.1)
    eta = ctx.attr("eta", 1.0)

    rois, probs, lod = [], [], [0]
    for i in range(scores.shape[0]):
        sc = scores[i].transpose(1, 2, 0).reshape(-1)        # HWA order
        dl = deltas[i].reshape(-1, 4, *deltas.shape[2:]) \
            .transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc)
        if pre_n > 0:
            order = order[:pre_n]
        props = _decode_anchors(anchors[order], dl[order],
                                variances[order] if variances is not None
                                else None)
        h, w = im_info[i, 0], im_info[i, 1]
        props[:, 0::2] = np.clip(props[:, 0::2], 0, w - 1)
        props[:, 1::2] = np.clip(props[:, 1::2], 0, h - 1)
        ws = props[:, 2] - props[:, 0] + 1
        hs = props[:, 3] - props[:, 1] + 1
        ms = min_size * im_info[i, 2]
        keep = (ws >= ms) & (hs >= ms)
        props, sc_k = props[keep], sc[order][keep]
        if len(props):
            kept = _nms_plain(props, sc_k, nms_thresh, post_n, eta)
            props, sc_k = props[kept], sc_k[kept]
        rois.append(props)
        probs.append(sc_k)
        lod.append(lod[-1] + len(props))
    rois = np.concatenate(rois, 0).astype(np.float32) if lod[-1] else \
        np.zeros((1, 4), np.float32)
    probs = np.concatenate(probs, 0).astype(np.float32).reshape(-1, 1) \
        if lod[-1] else np.zeros((1, 1), np.float32)
    dev = _device(ctx, "Scores")
    the_lod = [(tuple(lod),)]
    return {"RpnRois": to_device(rois, dev),
            "RpnRoiProbs": to_device(probs, dev),
            "RpnRois@LOD": the_lod, "RpnRoiProbs@LOD": the_lod}


_SAMPLER_CALLS = [0]


def _op_rng(ctx):
    """A fresh draw each execution; a nonzero ``seed`` attr gives a
    reproducible stream that still varies by call (seed + call number)."""
    _SAMPLER_CALLS[0] += 1
    seed = ctx.attr("seed", 0)
    if seed:
        return np.random.RandomState(int(seed) + _SAMPLER_CALLS[0])
    return np.random.RandomState()  # OS entropy


def _sampler_grad(ctx):
    """No input of a sampler takes a grad.  The reference's generic grad
    re-runs the forward, which advances the sampler count: this advances
    it with no re-run, so seeded runs go on drawing the reference's
    samples."""
    _SAMPLER_CALLS[0] += 1
    return {}


def _drop_crowd(gt, crowd_flags, seg):
    s, e = seg
    g = gt[s:e]
    if crowd_flags is None:
        return g
    c = np.asarray(crowd_flags).reshape(-1)[s:e].astype(bool)
    return g[~c]


@register_op("rpn_target_assign",
             no_grad_inputs=("Anchor", "GtBoxes", "IsCrowd", "ImInfo",
                             "DistMat"))
def rpn_target_assign(ctx):
    """RPN training targets, per image (GtBoxes' LoD; crowd boxes left
    out): positives are each ground truth's best anchor and the anchors
    at IoU >= ``rpn_positive_overlap``, negatives those under
    ``rpn_negative_overlap``, subsampled to ``rpn_batch_size_per_im`` with
    ``rpn_fg_fraction``.  Indices are flat into ``[images * anchors]``."""
    anchors, gt_all, crowd = to_host(
        ctx.input("Anchor"), ctx.input("GtBoxes"), ctx.input("IsCrowd"))
    anchors = anchors.reshape(-1, 4)
    gt_all = gt_all.reshape(-1, 4)
    batch = ctx.attr("rpn_batch_size_per_im", 256)
    fg_frac = ctx.attr("rpn_fg_fraction", 0.5)
    pos_t = ctx.attr("rpn_positive_overlap", 0.7)
    neg_t = ctx.attr("rpn_negative_overlap", 0.3)
    use_random = ctx.attr("use_random", True)
    rng = _op_rng(ctx)
    segs = _segments(ctx.in_lod("GtBoxes"), len(gt_all))
    n_anchor = len(anchors)

    locs, scores, slabels, tbs = [], [], [], []
    for i, seg in enumerate(segs):
        gt = _drop_crowd(gt_all, crowd, seg)
        fg_idx, bg_idx, tb = _rpn_assign_one(
            anchors, gt, batch, fg_frac, pos_t, neg_t, use_random, rng)
        locs.append(fg_idx + i * n_anchor)
        scores.append(np.concatenate([fg_idx, bg_idx]) + i * n_anchor)
        slabels.append(np.concatenate([np.ones(len(fg_idx)),
                                       np.zeros(len(bg_idx))]))
        tbs.append(tb)
    dev = _device(ctx, "Anchor")
    return {"LocationIndex": to_device(
                np.concatenate(locs).astype(np.int64), dev),
            "ScoreIndex": to_device(
                np.concatenate(scores).astype(np.int64), dev),
            "TargetLabel": to_device(np.concatenate(slabels)
                                     .astype(np.int64).reshape(-1, 1), dev),
            "TargetBBox": to_device(
                np.concatenate(tbs).astype(np.float32), dev)}


def _rpn_assign_one(anchors, gt, batch, fg_frac, pos_t, neg_t, use_random,
                    rng):
    iou = _np_iou(gt, anchors) if len(gt) else \
        np.zeros((0, len(anchors)), np.float32)
    max_per_anchor = iou.max(0) if len(gt) else \
        np.zeros(len(anchors), np.float32)
    labels = np.full(len(anchors), -1, np.int32)
    # negatives first, so each ground truth's best anchor stays positive
    labels[max_per_anchor < neg_t] = 0
    if len(gt):
        labels[max_per_anchor >= pos_t] = 1
        best_anchor = iou.argmax(1)
        labels[best_anchor] = 1

    fg_idx = np.where(labels == 1)[0]
    bg_idx = np.where(labels == 0)[0]
    n_fg = int(batch * fg_frac)
    if len(fg_idx) > n_fg:
        drop = (rng.permutation(fg_idx)[n_fg:] if use_random
                else fg_idx[n_fg:])
        labels[drop] = -1
        fg_idx = np.where(labels == 1)[0]
    n_bg = batch - len(fg_idx)
    if len(bg_idx) > n_bg:
        drop = (rng.permutation(bg_idx)[n_bg:] if use_random
                else bg_idx[n_bg:])
        labels[drop] = -1
        bg_idx = np.where(labels == 0)[0]

    if len(gt) and len(fg_idx):
        match_gt = iou[:, fg_idx].argmax(0)
        tgt = gt[match_gt]
        a = anchors[fg_idx]
        aw = a[:, 2] - a[:, 0] + 1.0
        ah = a[:, 3] - a[:, 1] + 1.0
        acx = a[:, 0] + 0.5 * aw
        acy = a[:, 1] + 0.5 * ah
        gw = tgt[:, 2] - tgt[:, 0] + 1.0
        gh = tgt[:, 3] - tgt[:, 1] + 1.0
        gcx = tgt[:, 0] + 0.5 * gw
        gcy = tgt[:, 1] + 0.5 * gh
        tb = np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                       np.log(gw / aw), np.log(gh / ah)], 1)
    else:
        tb = np.zeros((0, 4), np.float32)
    return fg_idx, bg_idx, tb


@register_op("generate_proposal_labels",
             no_grad_inputs=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes",
                             "ImInfo"))
def generate_proposal_labels(ctx):
    """Sample RoIs for the detection head and give them class labels and
    per-class box targets, per image (the RpnRois and GtBoxes LoDs, crowd
    boxes left out): ``Rois`` with its LoD, ``LabelsInt32``,
    ``BboxTargets`` and the inside / outside weights, ``4 x class_nums``
    wide."""
    rois_all, gt_cls_all, gt_all, crowd = to_host(
        ctx.input("RpnRois"), ctx.input("GtClasses"), ctx.input("GtBoxes"),
        ctx.input("IsCrowd"))
    rois_all = rois_all.reshape(-1, 4)
    gt_cls_all = gt_cls_all.reshape(-1).astype(np.int64)
    gt_all = gt_all.reshape(-1, 4)
    attrs = dict(
        batch=ctx.attr("batch_size_per_im", 256),
        fg_frac=ctx.attr("fg_fraction", 0.25),
        fg_t=ctx.attr("fg_thresh", 0.5),
        bg_hi=ctx.attr("bg_thresh_hi", 0.5),
        bg_lo=ctx.attr("bg_thresh_lo", 0.0),
        n_class=ctx.attr("class_nums", 81),
        use_random=ctx.attr("use_random", True))
    rng = _op_rng(ctx)
    roi_segs = _segments(ctx.in_lod("RpnRois"), len(rois_all))
    gt_segs = _segments(ctx.in_lod("GtBoxes"), len(gt_all))
    if len(gt_segs) != len(roi_segs):
        gt_segs = [(0, len(gt_all))] * len(roi_segs)

    outs = {"rois": [], "labels": [], "tgt": [], "w_in": []}
    lod = [0]
    for seg_r, seg_g in zip(roi_segs, gt_segs):
        rois = rois_all[seg_r[0]: seg_r[1]]
        gt = _drop_crowd(gt_all, crowd, seg_g)
        keep = np.ones(seg_g[1] - seg_g[0], bool)
        if crowd is not None:
            keep = ~np.asarray(crowd).reshape(-1)[seg_g[0]: seg_g[1]] \
                .astype(bool)
        gt_cls = gt_cls_all[seg_g[0]: seg_g[1]][keep]
        r, l, t, w = _sample_rois_one(rois, gt, gt_cls, rng, **attrs)
        outs["rois"].append(r)
        outs["labels"].append(l)
        outs["tgt"].append(t)
        outs["w_in"].append(w)
        lod.append(lod[-1] + len(r))
    dev = _device(ctx, "RpnRois")
    w_in = np.concatenate(outs["w_in"], 0)
    return {"Rois": to_device(
                np.concatenate(outs["rois"], 0).astype(np.float32), dev),
            "LabelsInt32": to_device(
                np.concatenate(outs["labels"], 0).astype(np.int32), dev),
            "BboxTargets": to_device(np.concatenate(outs["tgt"], 0), dev),
            "BboxInsideWeights": to_device(w_in, dev),
            "BboxOutsideWeights": to_device(
                (w_in > 0).astype(np.float32), dev),
            "Rois@LOD": [(tuple(lod),)]}


def _sample_rois_one(rois, gt, gt_cls, rng, batch, fg_frac, fg_t, bg_hi,
                     bg_lo, n_class, use_random):
    cand = np.concatenate([rois, gt], 0) if len(gt) else rois
    iou = _np_iou(gt, cand) if len(gt) else \
        np.zeros((0, len(cand)), np.float32)
    max_iou = iou.max(0) if len(gt) else np.zeros(len(cand))
    gt_of = iou.argmax(0) if len(gt) else np.zeros(len(cand), np.int64)
    fg = np.where(max_iou >= fg_t)[0]
    bg = np.where((max_iou < bg_hi) & (max_iou >= bg_lo))[0]
    n_fg = min(int(batch * fg_frac), len(fg))
    n_bg = min(batch - n_fg, len(bg))
    if use_random:
        fg = rng.permutation(fg)[:n_fg]
        bg = rng.permutation(bg)[:n_bg]
    else:
        fg, bg = fg[:n_fg], bg[:n_bg]
    sel = np.concatenate([fg, bg])
    out_rois = cand[sel].astype(np.float32)
    labels = np.concatenate([
        gt_cls[gt_of[fg]] if len(gt) else np.zeros(len(fg), np.int64),
        np.zeros(len(bg), np.int64)]).astype(np.int64).reshape(-1, 1)

    tgt = np.zeros((len(sel), 4 * n_class), np.float32)
    w_in = np.zeros_like(tgt)
    if len(gt):
        g = gt[gt_of[fg]]
        a = cand[fg]
        aw = a[:, 2] - a[:, 0] + 1.0
        ah = a[:, 3] - a[:, 1] + 1.0
        acx = a[:, 0] + 0.5 * aw
        acy = a[:, 1] + 0.5 * ah
        gw = g[:, 2] - g[:, 0] + 1.0
        gh = g[:, 3] - g[:, 1] + 1.0
        deltas = np.stack([(g[:, 0] + 0.5 * gw - acx) / aw,
                           (g[:, 1] + 0.5 * gh - acy) / ah,
                           np.log(gw / aw), np.log(gh / ah)], 1)
        for j, (row, cls) in enumerate(zip(deltas, labels[:len(fg), 0])):
            tgt[j, 4 * cls: 4 * cls + 4] = row
            w_in[j, 4 * cls: 4 * cls + 4] = 1.0
    return out_rois, labels, tgt, w_in


@register_op("detection_map",
             no_grad_inputs=("DetectRes", "Label", "HasState", "PosCount",
                             "TruePos", "FalsePos"))
def detection_map(ctx):
    """mAP of one batch (``ap_type`` ``11point`` or ``integral``) of
    ranked detections ``[M, 6]`` (label, score, box) against labelled
    boxes ``[N, 6]`` or ``[N, 5]`` (label first, box last), per image by
    the LoDs.  ``PosCount`` / ``TruePos`` seed it with the accumulators of
    earlier batches; ``AccumPosCount`` / ``AccumTruePos`` are the updated
    ones, to feed back for a dataset's mAP."""
    det, gt, pos_count, true_pos = to_host(
        ctx.input("DetectRes"), ctx.input("Label"), ctx.input("PosCount"),
        ctx.input("TruePos"))
    overlap_t = ctx.attr("overlap_threshold", 0.5)
    ap_type = ctx.attr("ap_type", "integral")
    background = ctx.attr("background_label", 0)
    det_lod = ctx.in_lod("DetectRes")
    gt_lod = ctx.in_lod("Label")
    doff = det_lod[-1] if det_lod else (0, len(det))
    goff = gt_lod[-1] if gt_lod else (0, len(gt))

    tps, npos = {}, {}
    if pos_count is not None and pos_count.size:
        for c, n in pos_count.reshape(-1, 2):
            npos[int(c)] = int(n)
    if true_pos is not None and true_pos.size:
        for c, score, flag in true_pos.reshape(-1, 3):
            tps.setdefault(int(c), []).append((float(score), int(flag)))
    for i in range(len(doff) - 1):
        d = det[int(doff[i]): int(doff[i + 1])]
        g = gt[int(goff[i]): int(goff[i + 1])]
        g_lab = g[:, 0].astype(int)
        g_box = g[:, -4:]
        for c in np.unique(g_lab):
            if c == background:
                continue
            npos[c] = npos.get(c, 0) + int((g_lab == c).sum())
        used = np.zeros(len(g), bool)
        order = np.argsort(-d[:, 1])
        for j in order:
            c = int(d[j, 0])
            if c == background:
                continue
            box = d[j, 2:6]
            cand = np.where((g_lab == c) & ~used)[0]
            tp = 0
            if len(cand):
                ious = _np_iou(box[None], g_box[cand])[0]
                k = ious.argmax()
                if ious[k] >= overlap_t:
                    used[cand[k]] = True
                    tp = 1
            tps.setdefault(c, []).append((d[j, 1], tp))

    aps = []
    for c, pairs in tps.items():
        if npos.get(c, 0) == 0:
            continue
        pairs.sort(key=lambda t: -t[0])
        tp_cum = np.cumsum([t for _, t in pairs])
        fp_cum = np.cumsum([1 - t for _, t in pairs])
        recall = tp_cum / npos[c]
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        if ap_type == "11point":
            ap = float(np.mean([precision[recall >= r].max()
                                if (recall >= r).any() else 0.0
                                for r in np.arange(0, 1.01, 0.1)]))
        else:  # integral
            ap = 0.0
            prev_r = 0.0
            for p, r in zip(precision, recall):
                ap += p * (r - prev_r)
                prev_r = r
        aps.append(ap)
    for c, n in npos.items():
        if c not in tps:
            aps.append(0.0)
    m_ap = float(np.mean(aps)) if aps else 0.0
    acc_pos = np.asarray([[c, n] for c, n in sorted(npos.items())],
                         np.float32).reshape(-1, 2) \
        if npos else np.zeros((0, 2), np.float32)
    acc_tp = np.asarray([[c, s, f] for c, pairs in sorted(tps.items())
                         for s, f in pairs], np.float32).reshape(-1, 3) \
        if tps else np.zeros((0, 3), np.float32)
    dev = _device(ctx, "Label")
    return {"MAP": to_device(np.asarray([m_ap], np.float32), dev),
            "AccumPosCount": to_device(acc_pos, dev),
            "AccumTruePos": to_device(acc_tp, dev),
            "AccumFalsePos": to_device(np.zeros((0, 3), np.float32), dev)}


register_grad("rpn_target_assign")(_sampler_grad)
register_grad("generate_proposal_labels")(_sampler_grad)
