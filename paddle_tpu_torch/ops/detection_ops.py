"""Detection ops (counterpart of ``paddle_tpu/ops/detection_ops.py``):
prior and anchor generation, box coding, IoU, bipartite matching, target
assignment, hard-example mining, multi-class NMS, RoI max pooling and the
polygon box transform.

Design on the card:
 - ``prior_box`` / ``anchor_generator`` depend only on the shapes and the
   attrs: built once in float32 on the host, as the reference's trace
   computes them, and cached on the device per (shapes, attrs, device).
 - ``bipartite_match`` runs one greedy loop over the whole batch: each
   image's distance rows are padded to the batch's largest row count with
   rows that never match, and the loop count (the largest
   ``min(rows, cols)``) comes from the LoD on the host.  Each step takes
   the first maximum in flat order (``torch.argmax``, as ``jnp.argmax``)
   and its "anything left" test stays on the device: no host read.
 - ``mine_hard_examples`` ranks with a stable sort, as ``jnp.argsort``.
 - ``multiclass_nms`` (a host op, ``registry.EAGER_OPS``) sorts, thresholds
   and sweeps on the input's device: a per-(image, class) IoU matrix of the
   ``nms_top_k`` candidates, then a greedy sweep over candidate positions
   vectorised across every (image, class); the kept rows are ordered as
   the reference orders them.  One host read a call: the kept counts,
   which the output's LoD needs (counted in :data:`stats`).
 - ``roi_pool`` takes the reference's bins (floor / ceil edges offset by
   the rounded RoI origin, clipped to the map, an empty bin 0) but never
   forms the reference's ``[R, C, ph, pw, H, W]`` mask: bins are grouped
   by their (height, width); one ``max_pool2d`` of that window size with
   stride 1 over the map gives each group's maxima and their positions,
   and the output is one gather of the map at those positions, so its
   generic grad goes to each bin's maximum.  The RoIs are read to the host
   once a call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from .sequence_ops import cached, device_index

# device-to-host reads made by the detection host ops and the greedy
# steps ``bipartite_match`` ran (``reset_stats`` zeroes them)
stats = {"host_reads": 0, "match_iterations": 0}

def reset_stats():
    stats["host_reads"] = stats["match_iterations"] = 0


def to_device(arr, device) -> torch.Tensor:
    """A host op's output on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def to_host(*tensors) -> list:
    """The values of ``tensors`` (None stays None) as numpy arrays of their
    own dtypes, read off the device in one transfer (counted in
    :data:`stats` when any came off a card).  CPU tensors cost no read."""
    out, todo = [], []
    for i, t in enumerate(tensors):
        if t is None or isinstance(t, np.ndarray):
            out.append(t)
        elif t.device.type == "cpu":
            out.append(t.detach().numpy())
        else:
            out.append(None)
            todo.append(i)
    if todo:
        stats["host_reads"] += 1
        # float64 holds float32 and the ids and flags exactly
        flat = torch.cat([tensors[i].detach().reshape(-1).to(torch.float64)
                          for i in todo]).cpu().numpy()
        k = 0
        for i in todo:
            t = tensors[i]
            n = t.numel()
            dtype = str(t.dtype).replace("torch.", "")
            out[i] = flat[k:k + n].astype(dtype).reshape(tuple(t.shape))
            k += n
    return out


# ---------------------------------------------------------------------------
# prior_box / anchor generation
# ---------------------------------------------------------------------------


def _expand_aspect_ratios(ratios, flip):
    out = [1.0]
    for ar in ratios or []:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _prior_whs(min_sizes, max_sizes, aspect_ratios, min_max_order):
    """The per-prior (half_w, half_h) table; the order differs under
    ``min_max_aspect_ratios_order``."""
    whs = []
    for s, mn in enumerate(min_sizes):
        if min_max_order:
            whs.append((mn / 2.0, mn / 2.0))
            if max_sizes:
                m = math.sqrt(mn * max_sizes[s]) / 2.0
                whs.append((m, m))
            for ar in aspect_ratios:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((mn * math.sqrt(ar) / 2.0,
                            mn / math.sqrt(ar) / 2.0))
        else:
            for ar in aspect_ratios:
                whs.append((mn * math.sqrt(ar) / 2.0,
                            mn / math.sqrt(ar) / 2.0))
            if max_sizes:
                m = math.sqrt(mn * max_sizes[s]) / 2.0
                whs.append((m, m))
    return whs


def _grid_boxes(fh, fw, offset, step_w, step_h, whs, scale_w, scale_h):
    """``[fh, fw, P, 4]`` float32 corner boxes around the grid's centres,
    each coordinate over its scale, in the reference's float32 order."""
    f32 = np.float32
    cx = (np.arange(fw, dtype=f32) + f32(offset)) * f32(step_w)
    cy = (np.arange(fh, dtype=f32) + f32(offset)) * f32(step_h)
    half = np.asarray(whs, f32).reshape(-1, 2)
    cxg = np.broadcast_to(cx[None, :, None], (fh, fw, len(half)))
    cyg = np.broadcast_to(cy[:, None, None], (fh, fw, len(half)))
    return np.stack([(cxg - half[:, 0]) / f32(scale_w),
                     (cyg - half[:, 1]) / f32(scale_h),
                     (cxg + half[:, 0]) / f32(scale_w),
                     (cyg + half[:, 1]) / f32(scale_h)], axis=-1)


def _with_variances(boxes, variances):
    var = np.broadcast_to(np.asarray(variances, np.float32), boxes.shape)
    return boxes, np.ascontiguousarray(var)


def _attr_key(ctx):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in ctx.attrs.items()
                        if not k.startswith("op_")))


@register_op("prior_box", no_grad_inputs=("Input", "Image"))
def prior_box(ctx):
    feat, image = ctx.input("Input"), ctx.input("Image")
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])

    def build():
        min_sizes = [float(v) for v in ctx.attr("min_sizes")]
        max_sizes = [float(v) for v in (ctx.attr("max_sizes") or [])]
        ratios = _expand_aspect_ratios(ctx.attr("aspect_ratios") or [],
                                       ctx.attr("flip", False))
        variances = [float(v) for v in ctx.attr("variances") or
                     [0.1, 0.1, 0.2, 0.2]]
        step_w = ctx.attr("step_w", 0.0) or img_w / fw
        step_h = ctx.attr("step_h", 0.0) or img_h / fh
        whs = _prior_whs(min_sizes, max_sizes, ratios,
                         ctx.attr("min_max_aspect_ratios_order", False))
        boxes = _grid_boxes(fh, fw, ctx.attr("offset", 0.5), step_w, step_h,
                            whs, img_w, img_h)
        if ctx.attr("clip", False):
            boxes = np.clip(boxes, 0.0, 1.0)
        return tuple(torch.as_tensor(a, device=feat.device)
                     for a in _with_variances(boxes, variances))

    boxes, var = cached(("prior_box", fh, fw, img_h, img_w, _attr_key(ctx),
                         str(feat.device)), build)
    return {"Boxes": boxes, "Variances": var}


@register_op("anchor_generator", no_grad_inputs=("Input",))
def anchor_generator(ctx):
    """RPN anchors in image coordinates (not normalized)."""
    feat = ctx.input("Input")
    fh, fw = int(feat.shape[2]), int(feat.shape[3])

    def build():
        sizes = [float(v) for v in ctx.attr("anchor_sizes")]
        ratios = [float(v) for v in ctx.attr("aspect_ratios") or [1.0]]
        variances = [float(v) for v in ctx.attr("variances") or
                     [0.1, 0.1, 0.2, 0.2]]
        stride = [float(v) for v in ctx.attr("stride")]
        whs = []
        for r in ratios:
            for s in sizes:
                base_w = round(math.sqrt(stride[0] * stride[1] / r))
                base_h = round(base_w * r)
                whs.append((s / stride[0] * base_w / 2.0,
                            s / stride[1] * base_h / 2.0))
        anchors = _grid_boxes(fh, fw, ctx.attr("offset", 0.5), stride[0],
                              stride[1], whs, 1, 1)
        return tuple(torch.as_tensor(a, device=feat.device)
                     for a in _with_variances(anchors, variances))

    anchors, var = cached(("anchor_generator", fh, fw, _attr_key(ctx),
                           str(feat.device)), build)
    return {"Anchors": anchors, "Variances": var}


# ---------------------------------------------------------------------------
# box_coder / iou_similarity
# ---------------------------------------------------------------------------


def _center_size(boxes, off):
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    cx = (boxes[..., 2] + boxes[..., 0]) / 2
    cy = (boxes[..., 3] + boxes[..., 1]) / 2
    return cx, cy, w, h


@register_op("box_coder", no_grad_inputs=("PriorBox", "PriorBoxVar",
                                          "TargetBox"))
def box_coder(ctx):
    """``encode_center_size``: target ``[N, 4]`` -> ``[N, M, 4]`` offsets
    from the ``M`` priors; ``decode_center_size``: deltas ``[N, M, 4]`` ->
    corner boxes."""
    prior = ctx.input("PriorBox")
    pvar = ctx.input("PriorBoxVar")
    target = ctx.input("TargetBox")
    off = 0.0 if ctx.attr("box_normalized", True) else 1.0
    pcx, pcy, pw, ph = _center_size(prior, off)
    if ctx.attr("code_type", "encode_center_size") == "encode_center_size":
        tcx, tcy, tw, th = _center_size(target, off)
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph[None, :],
            torch.log(torch.abs(tw[:, None] / pw[None, :])),
            torch.log(torch.abs(th[:, None] / ph[None, :]))], dim=-1)
        if pvar is not None:
            out = out / pvar[None, :, :]
    else:
        t = target if pvar is None else target * pvar[None, :, :]
        tcx = t[..., 0] * pw + pcx
        tcy = t[..., 1] * ph + pcy
        tw = torch.exp(t[..., 2]) * pw
        th = torch.exp(t[..., 3]) * ph
        out = torch.stack([tcx - tw / 2, tcy - th / 2,
                           tcx + tw / 2 - off, tcy + th / 2 - off], dim=-1)
    return {"OutputBox": out}


def iou_matrix(a, b, normalized=True):
    """IoU of ``a [..., N, 4]`` against ``b [..., M, 4]``: ``[..., N, M]``,
    0 where the union is not positive."""
    off = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    ix0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (ix1 - ix0 + off).clamp_min(0.0) * (iy1 - iy0 + off).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register_op("iou_similarity", no_grad_inputs=("X", "Y"))
def iou_similarity(ctx):
    return {"Out": iou_matrix(ctx.input("X"), ctx.input("Y"),
                              ctx.attr("box_normalized", True))}


# ---------------------------------------------------------------------------
# bipartite_match / target_assign / mine_hard_examples
# ---------------------------------------------------------------------------


def _segments(lod, total):
    """Per-image (start, end) pairs from a LoD, or one segment."""
    if lod:
        off = lod[-1]
        return [(int(off[i]), int(off[i + 1])) for i in range(len(off) - 1)]
    return [(0, int(total))]


def _padded_rows(segs, total):
    """Row ``r`` of each segment, or ``total`` (the padding row) past its
    end: ``[S * R]`` with ``R`` the longest segment."""
    width = max((e - s for s, e in segs), default=0)
    idx = np.full((len(segs), width), total, np.int64)
    for i, (s, e) in enumerate(segs):
        idx[i, :e - s] = np.arange(s, e)
    return idx.reshape(-1), width


@register_op("bipartite_match", no_grad_inputs=("DistMat",))
def bipartite_match(ctx):
    """Greedy global-maximum matching of each image's rows (ground truth,
    by the LoD) to the columns (priors): ``ColToRowMatchIndices`` int32
    ``[S, M]`` (-1 unmatched) and ``ColToRowMatchDist``; ``per_prediction``
    then matches each unmatched column to its best row when that distance
    reaches ``dist_threshold``."""
    dist = ctx.input("DistMat")
    total, cols = int(dist.shape[0]), int(dist.shape[1])
    segs = _segments(ctx.in_lod("DistMat"), total)
    idx, width = _padded_rows(segs, total)
    n = len(segs)
    rows = device_index(("bipartite_rows", tuple(segs)), dist.device,
                        lambda: idx)
    pad = torch.full((1, cols), -math.inf, dtype=dist.dtype,
                     device=dist.device)
    d = torch.cat([dist, pad]).index_select(0, rows).reshape(n, width, cols)
    col_to_row = torch.full((n, cols), -1, dtype=torch.int32,
                            device=dist.device)
    col_dist = torch.zeros((n, cols), dtype=dist.dtype, device=dist.device)
    row_used = torch.zeros((n, width), dtype=torch.bool, device=dist.device)
    eps = 1e-6
    steps = max((min(e - s, cols) for s, e in segs), default=0)
    stats["match_iterations"] += steps
    for _ in range(steps):
        masked = d.masked_fill(row_used[:, :, None]
                               | (col_to_row >= 0)[:, None, :], -math.inf)
        masked = masked.masked_fill(masked < eps, -math.inf).reshape(n, -1)
        flat = masked.argmax(dim=1, keepdim=True)
        best = masked.gather(1, flat)
        ok = best > -math.inf                               # [n, 1]
        i, j = flat // cols, flat % cols
        col_to_row.scatter_(1, j, torch.where(
            ok, i.to(torch.int32), col_to_row.gather(1, j)))
        col_dist.scatter_(1, j, torch.where(ok, best, col_dist.gather(1, j)))
        row_used.scatter_(1, i, ok | row_used.gather(1, i))
    if ctx.attr("match_type", "bipartite") == "per_prediction" and width:
        best_row = d.argmax(dim=1).to(torch.int32)
        best = d.amax(dim=1)
        extra = (col_to_row < 0) & (best >= ctx.attr("dist_threshold", 0.5))
        col_to_row = torch.where(extra, best_row, col_to_row)
        col_dist = torch.where(extra, best, col_dist)
    return {"ColToRowMatchIndices": col_to_row,
            "ColToRowMatchDist": col_dist}


@register_op("target_assign", no_grad_inputs=("X", "MatchIndices",
                                              "NegIndices"))
def target_assign(ctx):
    """``Out[n, m] = X[offset_n + match[n, m], m % P]`` where matched, else
    ``mismatch_value``; ``OutWeight`` 1 where matched.  ``NegIndices``
    either a ``[N, M]`` mask (``mine_hard_examples``) or LoD rows of
    indices, whose priors get weight 1."""
    x = ctx.input("X")                   # [sum_rows, P, K] (LoD rows)
    match = ctx.input("MatchIndices")    # [N, M], -1 = mismatch
    n, m = int(match.shape[0]), int(match.shape[1])
    p = int(x.shape[1])
    lod = ctx.in_lod("X")
    offsets = tuple(int(v) for v in lod[-1]) if lod else tuple(range(n + 1))
    off = device_index(("target_assign_off", offsets[:n]), x.device,
                       lambda: np.asarray(offsets[:n], np.int64))
    w_off = device_index(("target_assign_col", m, p), x.device,
                         lambda: np.arange(m) % p)
    rows = off[:, None] + match.long().clamp_min(0)
    matched = (match > -1)[..., None]
    out = x[rows, w_off[None, :], :].masked_fill(
        ~matched, ctx.attr("mismatch_value", 0))
    wt = matched.to(torch.float32)
    neg = ctx.input("NegIndices")
    if neg is not None and tuple(neg.shape) == (n, m):
        wt = torch.where(neg.bool()[..., None], torch.ones_like(wt), wt)
    elif neg is not None:
        neg_lod = ctx.in_lod("NegIndices")
        noff = tuple(int(v) for v in neg_lod[-1]) if neg_lod \
            else (0, int(neg.shape[0]))
        batch = device_index(
            ("target_assign_neg", noff), x.device,
            lambda: np.repeat(np.arange(len(noff) - 1), np.diff(noff)))
        wt = wt.index_put((batch, neg.reshape(-1).long()),
                          torch.ones((), dtype=wt.dtype, device=wt.device))
    return {"Out": out, "OutWeight": wt}


@register_op("mine_hard_examples",
             no_grad_inputs=("ClsLoss", "LocLoss", "MatchIndices",
                             "MatchDist"))
def mine_hard_examples(ctx):
    """``max_negative`` mining: the unmatched priors whose match distance
    is below ``neg_dist_threshold`` are ranked by loss (stable), the
    ``neg_pos_ratio`` x positives hardest kept (``NegIndices``, a bool
    ``[N, M]`` mask); the others become -2 in ``UpdatedMatchIndices``."""
    if ctx.attr("mining_type", "max_negative") != "max_negative":
        raise NotImplementedError("only max_negative mining is supported")
    cls_loss = ctx.input("ClsLoss")
    loc_loss = ctx.input("LocLoss")
    match = ctx.input("MatchIndices")
    match_dist = ctx.input("MatchDist")
    loss = cls_loss if loc_loss is None else cls_loss + (
        loc_loss if ctx.attr("sample_size", 0) else 0 * loc_loss)
    is_neg = match < 0
    if match_dist is not None:
        is_neg = is_neg & (match_dist < ctx.attr("neg_dist_threshold", 0.5))
    num_pos = (match >= 0).sum(dim=1)
    num_neg = torch.minimum(
        (num_pos.double() * ctx.attr("neg_pos_ratio", 1.0)).to(torch.int32),
        is_neg.sum(dim=1).to(torch.int32))
    neg_loss = torch.where(is_neg, loss, torch.full_like(loss, -math.inf))
    order = torch.argsort(-neg_loss, dim=1, stable=True)   # hardest first
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order).contiguous())
    selected = rank < num_neg[:, None]
    updated = torch.where(is_neg & ~selected,
                          torch.full_like(match, -2), match)
    return {"UpdatedMatchIndices": updated, "NegIndices": selected}


# ---------------------------------------------------------------------------
# multiclass_nms — a host op (its output count depends on the data)
# ---------------------------------------------------------------------------

# (image, class) problems whose IoU matrices one slice of the sweep's
# preparation holds at once
_NMS_CHUNK = 256


def _nms_suppression(boxes, normalized, thresh, eta):
    """For ``boxes [P, K, 4]``: the IoU matrices ``[P, K, K]`` compared
    with ``thresh`` (``eta`` >= 1: a bool "suppresses" matrix), or the IoU
    values themselves (``eta`` < 1: the threshold moves)."""
    p, k = int(boxes.shape[0]), int(boxes.shape[1])
    out = torch.empty((p, k, k), device=boxes.device,
                      dtype=torch.bool if eta >= 1 else boxes.dtype)
    for s in range(0, p, _NMS_CHUNK):
        iou = iou_matrix(boxes[s:s + _NMS_CHUNK], boxes[s:s + _NMS_CHUNK],
                         normalized)
        out[s:s + _NMS_CHUNK] = iou > thresh if eta >= 1 else iou
    return out


def _greedy_keep(valid, boxes, normalized, thresh, eta):
    """The reference's per-class hard NMS for every problem at once:
    candidates ``[P, K]`` in descending score order (``valid`` the ones
    past the score threshold), each kept unless a kept earlier candidate
    overlaps it by more than the threshold (which, with ``eta`` < 1,
    shrinks by ``eta`` after each kept candidate while above 0.5).
    Returns the kept mask ``[P, K]``."""
    p, k = valid.shape
    sup = _nms_suppression(boxes, normalized, thresh, eta)
    later = torch.ones((k, k), dtype=torch.bool,
                       device=valid.device).triu_(1)
    alive = valid.clone()
    adaptive = torch.full((p,), float(thresh), dtype=torch.float64,
                          device=valid.device)
    for t in range(k):
        kept = alive[:, t:t + 1]
        if eta >= 1:
            hit = sup[:, t]
        else:
            # the IoU (float32) against the threshold rounded to float32
            hit = sup[:, t] > adaptive.to(sup.dtype)[:, None]
        alive &= ~(hit & kept & later[t])
        if eta < 1:
            adaptive = torch.where(kept[:, 0] & (adaptive > 0.5),
                                   adaptive * eta, adaptive)
    return alive


@register_op("multiclass_nms", no_grad_inputs=("BBoxes", "Scores"))
def multiclass_nms(ctx):
    """``BBoxes [N, M, 4]``, ``Scores [N, C, M]`` -> ``Out [kept, 6]`` =
    (label, score, x0, y0, x1, y1) with one LoD segment an image: classes
    ascending (``background_label`` left out), each class's kept boxes in
    descending score order; past ``keep_top_k`` an image keeps its
    ``keep_top_k`` best by a stable sort on score.  Nothing kept gives the
    row ``[[-1]]``."""
    bboxes, scores = ctx.input("BBoxes"), ctx.input("Scores")
    bg = ctx.attr("background_label", 0)
    nms_top_k = ctx.attr("nms_top_k", -1)
    keep_top_k = ctx.attr("keep_top_k", -1)
    n, c, m = (int(v) for v in scores.shape)
    classes = [k for k in range(c) if k != bg]
    dev = scores.device
    cls_idx = device_index(("nms_classes", c, bg), dev,
                           lambda: np.asarray(classes, np.int64))
    s = scores.index_select(1, cls_idx)                     # [N, C', M]
    k = min(nms_top_k, m) if nms_top_k > -1 else m
    top_s, order = torch.sort(s, dim=2, descending=True, stable=True)
    top_s, order = top_s[..., :k], order[..., :k]
    cand = bboxes.gather(1, order.reshape(n, -1, 1).expand(-1, -1, 4))
    cand = cand.reshape(n * len(classes), k, 4)
    valid = (top_s > ctx.attr("score_threshold", 0.0)).reshape(-1, k)
    keep = _greedy_keep(valid, cand, ctx.attr("normalized", True),
                        ctx.attr("nms_threshold", 0.3),
                        ctx.attr("nms_eta", 1.0)).reshape(n, -1)
    width = keep.shape[1]                                    # C' * K
    flat_s = top_s.reshape(n, -1)
    # kept first, in class-major order; or by score, ties class-major
    class_major = torch.sort((~keep).to(torch.uint8), dim=1,
                             stable=True).indices
    by_score = torch.sort(flat_s.masked_fill(~keep, -math.inf), dim=1,
                          descending=True, stable=True).indices
    count = keep.sum(dim=1)
    if keep_top_k > -1:
        over = count > keep_top_k
        chosen = torch.where(over[:, None], by_score, class_major)
        count = torch.where(over, torch.full_like(count, keep_top_k), count)
    else:
        chosen = class_major
    stats["host_reads"] += dev.type != "cpu"
    counts = count.tolist()
    lod = tuple(np.concatenate([[0], np.cumsum(counts)]).astype(int).tolist())
    if not lod[-1]:
        return {"Out": torch.full((1, 1), -1.0, dtype=torch.float32,
                                  device=dev),
                "Out@LOD": [(lod,)]}
    picks = np.concatenate([i * width + np.arange(cnt)
                            for i, cnt in enumerate(counts)])
    f = chosen.reshape(-1)[torch.as_tensor(picks, device=dev)]
    img = torch.as_tensor(np.repeat(np.arange(n), counts), device=dev)
    label = cls_idx[f // k].to(torch.float32)
    score = flat_s[img, f]
    box = cand.reshape(n, width, 4)[img, f]
    out = torch.cat([label[:, None], score[:, None].float(), box.float()], 1)
    return {"Out": out, "Out@LOD": [(lod,)]}


# ---------------------------------------------------------------------------
# roi_pool / polygon_box_transform
# ---------------------------------------------------------------------------


def _roi_bins(rois, batch_of_roi, scale, ph, pw, h, w):
    """Each bin's clipped ``[start, end)`` rows and columns (the
    reference's floor / ceil edges from the rounded RoI origin):
    ``hs, he [R, ph]``, ``ws, we [R, pw]`` int64."""
    f32 = np.float32
    corner = np.round(np.asarray(rois, f32) * f32(scale)).astype(np.int64)
    x0, y0, x1, y1 = corner.T
    rh = np.maximum(y1 - y0 + 1, 1)
    rw = np.maximum(x1 - x0 + 1, 1)
    py, px = np.arange(ph), np.arange(pw)
    hs = np.clip(y0[:, None] + py * rh[:, None] // ph, 0, h)
    he = np.clip(y0[:, None] - (-(py + 1) * rh[:, None] // ph), 0, h)
    ws = np.clip(x0[:, None] + px * rw[:, None] // pw, 0, w)
    we = np.clip(x0[:, None] - (-(px + 1) * rw[:, None] // pw), 0, w)
    return hs, he, ws, we


def _roi_argmax(x, b, hs, he, ws, we):
    """The flat index into ``x`` of each bin's maximum, ``[R * ph * pw,
    C]`` int64, or ``x.numel()`` (the padding) for an empty bin.  Bins are
    grouped by size: one ``max_pool2d`` with stride 1 and the bin's size
    as window a group."""
    n, c, h, w = (int(v) for v in x.shape)
    r, ph, pw = hs.shape[0], hs.shape[1], ws.shape[1]
    bh = np.broadcast_to((he - hs)[:, :, None], (r, ph, pw)).reshape(-1)
    bw = np.broadcast_to((we - ws)[:, None, :], (r, ph, pw)).reshape(-1)
    top = np.broadcast_to(hs[:, :, None], (r, ph, pw)).reshape(-1)
    left = np.broadcast_to(ws[:, None, :], (r, ph, pw)).reshape(-1)
    img = np.repeat(b, ph * pw)
    dev = x.device
    arg = torch.full((r * ph * pw, c), n * c * h * w, dtype=torch.int64,
                     device=dev)
    plane = (torch.arange(c, device=dev) * (h * w))[None, :]
    live = (bh > 0) & (bw > 0)
    sizes = np.unique(np.stack([bh[live], bw[live]], 1), axis=0)
    with torch.no_grad():
        for kh, kw in sizes:
            sel = np.nonzero(live & (bh == kh) & (bw == kw))[0]
            _, where = F.max_pool2d(x, (int(kh), int(kw)), stride=1,
                                    return_indices=True)
            ow = w - int(kw) + 1
            at = torch.as_tensor(
                np.stack([img[sel], top[sel] * ow + left[sel]]), device=dev)
            pos = where.reshape(n, c, -1)[at[0], :, at[1]]     # [s, C]
            arg[torch.as_tensor(sel, device=dev)] = \
                (at[0] * (c * h * w))[:, None] + plane + pos
    return arg


@register_op("roi_pool", no_grad_inputs=("ROIs",))
def roi_pool(ctx):
    """Max-pool each RoI (``[R, 4]`` image coordinates; the LoD maps RoIs
    to images) into ``pooled_height x pooled_width`` bins: ``[R, C, ph,
    pw]``, 0 in an empty bin."""
    x = ctx.input("X")
    rois = ctx.input("ROIs")
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    n, c, h, w = (int(v) for v in x.shape)
    (rois_h,) = to_host(rois)
    r = int(rois_h.shape[0])
    b = np.zeros((r,), np.int64)
    for i, (s, e) in enumerate(_segments(ctx.in_lod("ROIs"), r)):
        b[s:e] = i
    hs, he, ws, we = _roi_bins(rois_h, b, ctx.attr("spatial_scale", 1.0),
                               ph, pw, h, w)
    arg = _roi_argmax(x, b, hs, he, ws, we)
    flat = torch.cat([x.reshape(-1), x.new_zeros(1)])
    out = flat[arg].reshape(r, ph, pw, c).permute(0, 3, 1, 2)
    return {"Out": out.contiguous()}


@register_op("polygon_box_transform", no_grad_inputs=("Input",))
def polygon_box_transform(ctx):
    """Per-pixel quad offsets to absolute coordinates: even channels
    ``4 * column - x``, odd ones ``4 * row - x``."""
    x = ctx.input("Input")
    _, c, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    row = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": torch.where(is_x, 4 * col, 4 * row) - x}
