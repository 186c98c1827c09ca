"""The port's Faster R-CNN host ops and mAP (``paddle_tpu_torch/ops/
rcnn_ops.py``) against the JAX package's, on the CPU, through
``test_torch_sequence_ops.py``'s ``compare_with_reference`` (the same
one-op Program in both packages; floats rtol 1e-5 / atol 1e-6, integers
and LoDs exactly).

Every case is a 2-image LoD batch.  ``rpn_target_assign`` and
``generate_proposal_labels`` get crowd flags and draw their samples with
a ``seed`` attr from numpy, as the reference does (seed + the module's
call count): both packages' counters are reset before each test, so the
two draw the same samples.  ``detection_map`` runs both AP kinds, and
chained: the first batch's accumulators fed back with a second batch.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.ops import rcnn_ops as ref_rcnn
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import rcnn_ops as port_rcnn
from test_torch_sequence_ops import (_build, _run, compare_with_reference,
                                     feed)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    ref_rcnn._SAMPLER_CALLS[0] = port_rcnn._SAMPLER_CALLS[0] = 0
    yield


def _pixel_boxes(rng, n, w=64.0, h=48.0, lo=4.0, hi=20.0):
    x0 = rng.uniform(0, w - hi, n)
    y0 = rng.uniform(0, h - hi, n)
    bw, bh = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    return np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)


def _anchors(fh=3, fw=4, stride=16.0, sizes=(16.0, 32.0), ratios=(0.5, 1.0)):
    """``[fh, fw, A, 4]`` anchors as ``anchor_generator`` lays them out."""
    out = np.zeros((fh, fw, len(sizes) * len(ratios), 4), np.float32)
    k = 0
    for r in ratios:
        for s in sizes:
            hw, hh = s * np.sqrt(1 / r) / 2, s * np.sqrt(r) / 2
            for i in range(fh):
                for j in range(fw):
                    cx, cy = (j + 0.5) * stride, (i + 0.5) * stride
                    out[i, j, k] = [cx - hw, cy - hh, cx + hw, cy + hh]
            k += 1
    return out


def _cases():
    rng = np.random.RandomState(21)
    cases = {}
    anchors = _anchors()
    a = anchors.shape[2]
    scores = ((rng.permutation(2 * a * 12) + 1.0) / (2 * a * 12 + 1.0)) \
        .reshape(2, a, 3, 4).astype(np.float32)
    deltas = (rng.standard_normal((2, 4 * a, 3, 4)) * 0.2).astype(np.float32)
    im_info = np.array([[48.0, 64.0, 1.0], [40.0, 60.0, 1.5]], np.float32)
    for name, attrs, var in (
            ("generate_proposals", dict(pre_nms_topN=30, post_nms_topN=12,
                                        nms_thresh=0.5, min_size=2.0), True),
            ("generate_proposals_eta", dict(pre_nms_topN=-1,
                                            post_nms_topN=-1, nms_thresh=0.8,
                                            min_size=0.0, eta=0.7), False)):
        inputs = {"Scores": [feed(scores)], "BboxDeltas": [feed(deltas)],
                  "ImInfo": [feed(im_info)],
                  "Anchors": [feed(anchors)]}
        if var:
            inputs["Variances"] = [feed(np.full(anchors.shape, 0.5,
                                                np.float32))]
        cases[name] = ("generate_proposals", inputs, attrs,
                       ("RpnRois", "RpnRoiProbs"))

    gt = np.concatenate([_pixel_boxes(rng, 3), _pixel_boxes(rng, 4)])
    gt[1] = anchors[1, 2, 1] + 0.5       # a ground truth on an anchor
    crowd = np.array([[0], [0], [1], [0], [1], [0], [0]], np.int32)
    for name, random in (("rpn_target_assign", False),
                         ("rpn_target_assign_random", True)):
        cases[name] = (
            "rpn_target_assign",
            {"Anchor": [feed(anchors.reshape(-1, 4))],
             "GtBoxes": [feed(gt, [[3, 4]])],
             "IsCrowd": [feed(crowd, [[3, 4]])],
             "ImInfo": [feed(im_info)]},
            dict(rpn_batch_size_per_im=10, rpn_fg_fraction=0.3,
                 rpn_positive_overlap=0.5, rpn_negative_overlap=0.3,
                 use_random=random, seed=5),
            ("LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox"))

    rois = np.concatenate([_pixel_boxes(rng, 9), gt[:3] + 1.0,
                           _pixel_boxes(rng, 7), gt[3:] - 1.0])
    classes = rng.randint(1, 6, (7, 1)).astype(np.int32)
    for name, random in (("proposal_labels", False),
                         ("proposal_labels_random", True)):
        cases[name] = (
            "generate_proposal_labels",
            {"RpnRois": [feed(rois, [[12, 11]])],
             "GtClasses": [feed(classes, [[3, 4]])],
             "IsCrowd": [feed(crowd, [[3, 4]])],
             "GtBoxes": [feed(gt, [[3, 4]])],
             "ImInfo": [feed(im_info)]},
            dict(batch_size_per_im=8, fg_fraction=0.25, fg_thresh=0.5,
                 bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                 bbox_reg_weights=[0.1, 0.1, 0.2, 0.2], class_nums=6,
                 use_random=random, seed=9),
            ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights"))

    for ap in ("integral", "11point"):
        det, label = _map_batch(rng)
        cases[f"detection_map_{ap}"] = (
            "detection_map",
            {"DetectRes": [feed(det, [[5, 6]])],
             "Label": [feed(label, [[3, 4]])]},
            dict(overlap_threshold=0.5, ap_type=ap, class_num=4,
                 background_label=0, evaluate_difficult=False),
            ("MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"))
    return cases


def _map_batch(rng, n_det=(5, 6), n_gt=(3, 4)):
    """Detections (label, score, box) near and far from labelled boxes
    (label, difficult, box) of 3 classes, two images."""
    dets, labels = [], []
    for nd, ng in zip(n_det, n_gt):
        g = _pixel_boxes(rng, ng)
        gl = rng.randint(1, 4, ng)
        labels.append(np.concatenate([gl[:, None], rng.randint(0, 2, (ng, 1)),
                                      g], 1))
        pick = rng.randint(0, ng, nd)
        box = g[pick] + rng.uniform(-3, 3, (nd, 4))
        box[::3] += 25.0                  # some misses
        lab = np.where(rng.uniform(size=nd) < 0.8, gl[pick],
                       rng.randint(1, 4, nd))
        dets.append(np.concatenate([lab[:, None],
                                    rng.uniform(0.05, 1, (nd, 1)), box], 1))
    return (np.concatenate(dets).astype(np.float32),
            np.concatenate(labels).astype(np.float32))


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_rcnn_op_matches_reference(name):
    compare_with_reference(CASES[name])


def test_seeded_samplers_draw_what_the_reference_draws():
    """With ``use_random``, ``rpn_target_assign`` subsamples (more
    candidates than its batch) and the seeded draws of both packages keep
    the same anchors over three calls."""
    case = CASES["rpn_target_assign_random"]
    got = {}
    for pkg, mod in ((rf, ref_rcnn), (tf, port_rcnn)):
        mod._SAMPLER_CALLS[0] = 0
        main, feeds, outs, _ = _build(pkg, case)
        got[pkg] = [np.asarray(_run(pkg, main, feeds, outs)[1]).tolist()
                    for _ in range(3)]
    assert got[tf] == got[rf]
    assert got[tf][0] != got[tf][1]          # the stream moves per call
    n_candidates = 2 * 3 * 4 * 4
    assert len(got[tf][0]) == 20 < n_candidates


def test_detection_map_chains_like_the_reference():
    """Two batches chained through the accumulators (``PosCount`` /
    ``TruePos`` from the first batch's ``AccumPosCount`` /
    ``AccumTruePos``), both AP kinds: equal in both packages, and equal to
    one evaluation of both batches together."""
    rng = np.random.RandomState(4)
    (d1, l1), (d2, l2) = _map_batch(rng), _map_batch(rng)
    for ap in ("integral", "11point"):
        attrs = dict(overlap_threshold=0.5, ap_type=ap, class_num=4)
        outs = ("MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos")
        first = ("detection_map",
                 {"DetectRes": [feed(d1, [[5, 6]])],
                  "Label": [feed(l1, [[3, 4]])]}, attrs, outs)
        maps = {}
        for pkg in (rf, tf):
            main, feeds, names, _ = _build(pkg, first)
            m1, pos, tp, _ = (np.asarray(v) for v in
                              _run(pkg, main, feeds, names))
            second = ("detection_map",
                      {"DetectRes": [feed(d2, [[5, 6]])],
                       "Label": [feed(l2, [[3, 4]])],
                       "PosCount": [feed(pos)], "TruePos": [feed(tp)]},
                      attrs, outs)
            main, feeds, names, _ = _build(pkg, second)
            maps[pkg] = [np.asarray(v) for v in _run(pkg, main, feeds, names)]
            both = ("detection_map",
                    {"DetectRes": [feed(np.concatenate([d1, d2]),
                                        [[5, 6, 5, 6]])],
                     "Label": [feed(np.concatenate([l1, l2]),
                                    [[3, 4, 3, 4]])]}, attrs, outs)
            main, feeds, names, _ = _build(pkg, both)
            whole = np.asarray(_run(pkg, main, feeds, names)[0])
            np.testing.assert_allclose(maps[pkg][0], whole, atol=1e-6)
        for r, p in zip(maps[rf], maps[tf]):
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)
