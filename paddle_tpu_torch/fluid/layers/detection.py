"""Detection layers (counterpart of ``paddle_tpu/fluid/layers/detection.py``):
the builders of SSD (priors, box coding, matching, target assignment,
hard-example mining, ``ssd_loss``, ``multi_box_head``, decoding by
``detection_output`` and scoring by ``detection_map``) and of Faster R-CNN
(anchors, ``rpn_target_assign``, ``generate_proposals``,
``generate_proposal_labels``, ``roi_pool``), copied so the same calls emit
the same ops, attrs and static shapes.

``detection_output`` decodes the boxes and runs ``multiclass_nms`` on
``scores`` as given, as the reference's does: ``multiclass_nms`` reads
``[N, C, M]`` scores, so a caller holding ``multi_box_head``'s ``[N, M, C]``
logits applies the softmax and the transpose itself."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "box_coder", "iou_similarity", "bipartite_match",
    "target_assign", "multiclass_nms", "detection_output", "roi_pool",
    "anchor_generator", "polygon_box_transform",
    "detection_map", "rpn_target_assign", "generate_proposals",
    "generate_proposal_labels", "ssd_loss", "multi_box_head",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", **locals())
    dtype = helper.input_dtype("input")
    boxes = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset,
               "min_max_aspect_ratios_order": min_max_aspect_ratios_order})
    # priors are constants of the data path (ref prior_box layer sets
    # stop_gradient); without this, backward demands a grad no op provides
    boxes.stop_gradient = True
    var.stop_gradient = True
    return boxes, var


def anchor_generator(input, anchor_sizes, aspect_ratios=(1.0,),
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", **locals())
    dtype = helper.input_dtype("input")
    anchors = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [var]},
        attrs={"anchor_sizes": list(anchor_sizes),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "stride": list(stride),
               "offset": offset})
    anchors.stop_gradient = True
    var.stop_gradient = True
    return anchors, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype("target_box"))
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype("x"))
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"box_normalized": box_normalized})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(
        helper.input_dtype("dist_matrix"))
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_dist]},
        attrs={"match_type": match_type, "dist_threshold": dist_threshold})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype("input"))
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": [out], "OutWeight": [out_weight]},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1,
                   keep_top_k=-1, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    helper = LayerHelper("multiclass_nms", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype("bboxes"))
    helper.append_op(
        type="multiclass_nms", inputs={"BBoxes": [bboxes],
                                       "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode ``loc`` against the priors, then ``multiclass_nms`` over
    ``scores`` (``[N, C, M]``) as given."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    helper = LayerHelper("roi_pool", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype("input"))
    helper.append_op(type="roi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype("input"))
    helper.append_op(type="polygon_box_transform", inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return out

def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None,
                  out_states=None, ap_version="integral"):
    """mAP evaluation op wrapper (ref layers/detection.py detection_map
    :315 — default overlap 0.3).  For dataset-level mAP pass
    ``input_states`` (prev accumulators) and ``out_states`` (vars to
    receive the updated accumulators), then feed out_states back in as
    input_states next batch — the reference's chaining contract."""
    helper = LayerHelper("detection_map", **locals())
    m = helper.create_variable_for_type_inference("float32")
    m.shape = (1,)
    if out_states is not None:
        acc_pos, acc_tp, acc_fp = out_states
    else:
        acc_pos = helper.create_variable_for_type_inference("float32")
        acc_tp = helper.create_variable_for_type_inference("float32")
        acc_fp = helper.create_variable_for_type_inference("float32")
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    if input_states is not None:
        inputs["PosCount"] = [input_states[0]]
        inputs["TruePos"] = [input_states[1]]
        inputs["FalsePos"] = [input_states[2]]
    helper.append_op(
        type="detection_map", inputs=inputs,
        outputs={"MAP": [m], "AccumPosCount": [acc_pos],
                 "AccumTruePos": [acc_tp], "AccumFalsePos": [acc_fp]},
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    if out_states is not None:
        return m, acc_pos, acc_tp, acc_fp
    return m


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info, rpn_batch_size_per_im=256,
                      rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=True):
    """RPN training-target assignment (ref layers/detection.py
    rpn_target_assign, operators/detection/rpn_target_assign_op.cc)."""
    helper = LayerHelper("rpn_target_assign", **locals())
    loc_index = helper.create_variable_for_type_inference("int64")
    score_index = helper.create_variable_for_type_inference("int64")
    target_label = helper.create_variable_for_type_inference("int64")
    target_bbox = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    helper.append_op(
        type="rpn_target_assign",
        inputs={"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
                "IsCrowd": [is_crowd], "ImInfo": [im_info]},
        outputs={"LocationIndex": [loc_index],
                 "ScoreIndex": [score_index],
                 "TargetLabel": [target_label],
                 "TargetBBox": [target_bbox]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "rpn_fg_fraction": rpn_fg_fraction,
               "use_random": use_random})
    # gather the predictions the assignment selected (ref :186-194)
    from .nn import gather, reshape

    cls_logits = reshape(cls_logits, shape=[-1, 1])
    bbox_pred = reshape(bbox_pred, shape=[-1, 4])
    predicted_cls_logits = gather(cls_logits, score_index)
    predicted_bbox_pred = gather(bbox_pred, loc_index)
    return (predicted_cls_logits, predicted_bbox_pred, target_label,
            target_bbox)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0):
    """RPN proposal generation (ref layers/detection.py generate_proposals,
    operators/detection/generate_proposals_op.cc)."""
    helper = LayerHelper("generate_proposals", **locals())
    rois = helper.create_variable_for_type_inference(scores.dtype)
    roi_probs = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [roi_probs]},
        attrs={"pre_nms_topN": pre_nms_top_n,
               "post_nms_topN": post_nms_top_n, "nms_thresh": nms_thresh,
               "min_size": min_size, "eta": eta})
    return rois, roi_probs


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True):
    """Sample + label RoIs for the detection head (ref layers/detection.py
    generate_proposal_labels, generate_proposal_labels_op.cc)."""
    helper = LayerHelper("generate_proposal_labels", **locals())
    dtype = rpn_rois.dtype
    rois = helper.create_variable_for_type_inference(dtype)
    labels_int32 = helper.create_variable_for_type_inference("int32")
    bbox_targets = helper.create_variable_for_type_inference(dtype)
    bbox_inside = helper.create_variable_for_type_inference(dtype)
    bbox_outside = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
                "ImInfo": [im_info]},
        outputs={"Rois": [rois], "LabelsInt32": [labels_int32],
                 "BboxTargets": [bbox_targets],
                 "BboxInsideWeights": [bbox_inside],
                 "BboxOutsideWeights": [bbox_outside]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums, "use_random": use_random})
    return (rois, labels_int32, bbox_targets, bbox_inside, bbox_outside)



def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (ref: layers/detection.py ssd_loss — match gt to
    priors, mine hard negatives, weighted smooth-l1 + softmax CE).

    location [N, Np, 4]; confidence [N, Np, C]; gt_box/gt_label LoD
    tensors [Ng, 4]/[Ng, 1]; prior_box [Np, 4].  Returns the [N, 1]
    per-image loss (summed over priors, optionally normalized by the
    positive count).
    """
    from . import nn as _nn
    from . import tensor as _tensor

    helper = LayerHelper("ssd_loss", **locals())
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == 'max_negative' is supported")
    num_prior = confidence.shape[1]

    def to_2d(var):
        return _nn.flatten(var, axis=2)

    # 1. match gt to priors on IoU
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(iou, match_type,
                                                    overlap_threshold)

    # 2. provisional confidence loss drives hard-negative mining
    # (this build's target_assign takes X as LoD rows [Ng, P, K])
    gt_label = _nn.reshape(gt_label, [-1, 1, 1])
    gt_label.stop_gradient = True
    target_label, _ = target_assign(gt_label, matched_indices,
                                    mismatch_value=background_label)
    conf2d = to_2d(confidence)
    target_label_2d = _tensor.cast(to_2d(target_label), "int64")
    target_label_2d.stop_gradient = True
    conf_loss = _nn.softmax_with_cross_entropy(conf2d, target_label_2d)
    conf_loss = _nn.reshape(conf_loss, [-1, num_prior])
    conf_loss.stop_gradient = True

    neg_indices = helper.create_variable_for_type_inference("int32")
    updated_indices = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="mine_hard_examples",
        inputs={"ClsLoss": [conf_loss], "MatchIndices": [matched_indices],
                "MatchDist": [matched_dist]},
        outputs={"NegIndices": [neg_indices],
                 "UpdatedMatchIndices": [updated_indices]},
        attrs={"neg_pos_ratio": neg_pos_ratio,
               "neg_dist_threshold": neg_overlap,
               "mining_type": mining_type,
               "sample_size": sample_size or 0})

    # 3. regression targets: encoded gt assigned to matched priors
    encoded = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                        target_box=gt_box,
                        code_type="encode_center_size")
    target_bbox, target_loc_weight = target_assign(
        encoded, updated_indices, mismatch_value=background_label)
    # 4. classification targets incl. mined negatives
    target_label, target_conf_weight = target_assign(
        gt_label, updated_indices, negative_indices=neg_indices,
        mismatch_value=background_label)

    target_label = _tensor.cast(to_2d(target_label), "int64")
    target_label.stop_gradient = True
    conf_loss = _nn.softmax_with_cross_entropy(conf2d, target_label)
    tcw = _nn.reshape(target_conf_weight, [-1, 1])
    tcw.stop_gradient = True
    conf_loss = _nn.elementwise_mul(conf_loss, tcw)

    loc2d = to_2d(location)
    tb = to_2d(target_bbox)
    tb.stop_gradient = True
    loc_loss = _nn.smooth_l1(loc2d, tb)
    tlw = _nn.reshape(target_loc_weight, [-1, 1])
    tlw.stop_gradient = True
    loc_loss = _nn.elementwise_mul(loc_loss, tlw)

    loss = _nn.elementwise_add(
        _nn.scale(conf_loss, scale=float(conf_loss_weight)),
        _nn.scale(loc_loss, scale=float(loc_loss_weight)))
    loss = _nn.reshape(loss, [-1, num_prior])
    loss = _nn.reduce_sum(loss, dim=1, keep_dim=True)
    if normalize:
        normalizer = _nn.reduce_sum(target_loc_weight)
        loss = _nn.elementwise_div(loss, normalizer)
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (ref: layers/detection.py multi_box_head): per
    feature map, a conv pair predicts box offsets and class scores for
    that map's priors; priors come from prior_box.  Returns
    (mbox_locs [N, P, 4], mbox_confs [N, P, C], boxes [P, 4],
    variances [P, 4]) concatenated over maps.
    """
    from . import nn as _nn
    from . import tensor as _tensor

    n_maps = len(inputs)
    if min_sizes is None:
        # the reference's ratio schedule (ref multi_box_head: min_ratio..
        # max_ratio split across maps, first map pinned to 10%/20%);
        # degenerate map counts fall back to an even split
        min_sizes, max_sizes = [], []
        if n_maps > 2:
            step_r = int((max_ratio - min_ratio) / (n_maps - 2))
            for r in range(min_ratio, max_ratio + 1, step_r):
                min_sizes.append(base_size * r / 100.0)
                max_sizes.append(base_size * (r + step_r) / 100.0)
            min_sizes = [base_size * 0.10] + min_sizes
            max_sizes = [base_size * 0.20] + max_sizes
        else:
            span = (max_ratio - min_ratio) / max(1, n_maps)
            for i in range(n_maps):
                lo = min_ratio + span * i
                min_sizes.append(base_size * lo / 100.0)
                max_sizes.append(base_size * (lo + span) / 100.0)
        min_sizes = min_sizes[:n_maps]
        max_sizes = max_sizes[:n_maps]

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        mins_l = mins if isinstance(mins, (list, tuple)) else [mins]
        maxs_l = (maxs if isinstance(maxs, (list, tuple))
                  else ([maxs] if maxs else []))
        ars = aspect_ratios[i]
        ars_l = list(ars) if isinstance(ars, (list, tuple)) else [ars]
        step = (steps[i] if steps else
                ((step_w[i] if step_w else 0.0),
                 (step_h[i] if step_h else 0.0)))
        if not isinstance(step, (list, tuple)):
            step = (step, step)
        # priors per location: the EXACT count the prior_box op emits
        from ...ops.detection_ops import _expand_aspect_ratios, _prior_whs

        num_priors = len(_prior_whs(
            [float(v) for v in mins_l],
            [float(v) for v in maxs_l],
            _expand_aspect_ratios(ars_l, flip),
            min_max_aspect_ratios_order))

        loc = _nn.conv2d(feat, num_filters=num_priors * 4,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        conf = _nn.conv2d(feat, num_filters=num_priors * num_classes,
                          filter_size=kernel_size, padding=pad,
                          stride=stride)
        # priors are generated from the CONV OUTPUT map, not the input
        # feature map: with kernel_size>1/pad=0 or stride>1 the conv
        # shrinks the map, and the prediction grid (which the priors must
        # tile one-to-one) is the conv output.  Generating both from the
        # same tensor keeps mbox_locs/confs and boxes counts in agreement
        # for every kernel/pad/stride combination.
        boxes, var = prior_box(loc, image, mins_l, maxs_l or None, ars_l,
                               variance, flip, clip, step, offset,
                               min_max_aspect_ratios_order=
                               min_max_aspect_ratios_order)
        # NCHW -> [N, H*W*num_priors, 4 or C] (static prior count so the
        # ssd_loss reshape chain keeps concrete shapes)
        fh, fw = loc.shape[2], loc.shape[3]
        p_i = int(fh) * int(fw) * int(num_priors)
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        locs.append(_nn.reshape(loc, [-1, p_i, 4]))
        confs.append(_nn.reshape(conf, [-1, p_i, num_classes]))
        boxes_all.append(_nn.reshape(boxes, [-1, 4]))
        vars_all.append(_nn.reshape(var, [-1, 4]))

    mbox_locs = _tensor.concat(locs, axis=1)
    mbox_confs = _tensor.concat(confs, axis=1)
    boxes = _tensor.concat(boxes_all, axis=0)
    variances = _tensor.concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances
