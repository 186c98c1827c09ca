"""The port's detection ops (``paddle_tpu_torch/ops/detection_ops.py``), the
``flatten`` op and the ``rmsprop`` op against the JAX package's, on the
CPU.  Each case builds the same one-op Program in both packages, feeds the
same numpy-seeded inputs, and compares, through
``test_torch_sequence_ops.py``'s ``compare_with_reference``,

 - every output (fp32 rtol 1e-5 / atol 1e-6; integer and bool outputs
   exactly) and its LoD;
 - the grads of the differentiable inputs, from ``append_backward`` of
   ``sum(out * c)`` with a numpy-seeded ``c`` per float output (the same
   tolerance).

Cases: ``prior_box`` (flip, clip, explicit steps, both prior orders),
``anchor_generator``, ``box_coder`` (encode and decode, normalized or in
pixels, with and without variances), ``iou_similarity``,
``bipartite_match`` over LoD segments (more rows than columns, distances
under its epsilon, ``per_prediction``), ``target_assign`` (labels and
boxes, mask and LoD-index ``NegIndices``), ``mine_hard_examples`` (with
and without ``sample_size``), ``multiclass_nms`` on tie-free scores
(defaults, ``nms_eta`` < 1, ``keep_top_k`` under the kept count,
``normalized`` False, a background class, nothing kept), ``roi_pool``
(RoIs over two images, one past the map, one whose bins are all empty,
RoIs smaller than the bins; the grad of the map, whose values are
tie-free: the port's grad goes to each bin's maximum, the reference's
splits ties), ``polygon_box_transform``, ``flatten`` at three axes and
``rmsprop`` at momentum 0 and 0.9.
"""

import numpy as np
import pytest

from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import compare_with_reference, const, feed


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _boxes(rng, n, scale=1.0, centers=None):
    """``n`` corner boxes (x0 < x1, y0 < y1) of side 0.1-0.4 x ``scale``,
    jittered around ``centers`` when given (so NMS has overlaps)."""
    if centers is None:
        c = rng.uniform(0.2, 0.8, (n, 2))
    else:
        c = centers[rng.randint(0, len(centers), n)] + \
            rng.uniform(-0.04, 0.04, (n, 2))
    half = rng.uniform(0.05, 0.2, (n, 2))
    return (np.concatenate([c - half, c + half], 1) * scale).astype(
        np.float32)


def _nms_inputs(rng, n=2, m=24, c=4, scale=1.0):
    centers = rng.uniform(0.25, 0.75, (4, 2))
    boxes = np.stack([_boxes(rng, m, scale, centers) for _ in range(n)])
    # tie-free scores: a permutation of distinct values
    scores = (rng.permutation(n * c * m).reshape(n, c, m) + 1.0) / (
        n * c * m + 1.0)
    return boxes, scores.astype(np.float32)


def _cases():
    rng = np.random.RandomState(11)
    cases = {}
    img = _f32(rng, 1, 3, 24, 40)
    for name, attrs in {
            "prior_box": dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 14.0],
                              aspect_ratios=[2.0, 3.0], flip=True,
                              clip=False),
            "prior_box_clip_steps": dict(
                min_sizes=[10.0], max_sizes=[], aspect_ratios=[2.0],
                flip=True, clip=True, step_w=7.0, step_h=9.0, offset=0.3),
            "prior_box_minmax_order": dict(
                min_sizes=[4.0, 8.0], max_sizes=[8.0, 14.0],
                aspect_ratios=[2.0], flip=False, clip=False,
                min_max_aspect_ratios_order=True,
                variances=[0.1, 0.2, 0.3, 0.4])}.items():
        cases[name] = ("prior_box",
                       {"Input": [feed(_f32(rng, 1, 4, 3, 5))],
                        "Image": [feed(img)]}, attrs,
                       ("Boxes", "Variances"))
    cases["anchor_generator"] = (
        "anchor_generator", {"Input": [feed(_f32(rng, 1, 2, 3, 4))]},
        dict(anchor_sizes=[32.0, 64.0, 128.0], aspect_ratios=[0.5, 1.0, 2.0],
             variances=[1.0, 1.0, 1.0, 1.0], stride=[16.0, 16.0],
             offset=0.5), ("Anchors", "Variances"))

    prior, pvar = _boxes(rng, 7), np.abs(_f32(rng, 7, 4)) + 0.1
    target = _boxes(rng, 5)
    cases["box_encode"] = (
        "box_coder", {"PriorBox": [feed(prior)], "PriorBoxVar": [feed(pvar)],
                      "TargetBox": [feed(target, [[2, 3]])]},
        {"code_type": "encode_center_size"}, ("OutputBox",))
    cases["box_encode_pixels_novar"] = (
        "box_coder", {"PriorBox": [feed(_boxes(rng, 6, 50.0))],
                      "TargetBox": [feed(_boxes(rng, 3, 50.0))]},
        {"code_type": "encode_center_size", "box_normalized": False},
        ("OutputBox",))
    cases["box_decode"] = (
        "box_coder", {"PriorBox": [feed(prior)], "PriorBoxVar": [feed(pvar)],
                      "TargetBox": [feed(_f32(rng, 3, 7, 4) * 0.3)]},
        {"code_type": "decode_center_size"}, ("OutputBox",))
    cases["box_decode_pixels"] = (
        "box_coder", {"PriorBox": [feed(_boxes(rng, 7, 40.0))],
                      "TargetBox": [feed(_f32(rng, 2, 7, 4) * 0.3)]},
        {"code_type": "decode_center_size", "box_normalized": False},
        ("OutputBox",))
    for norm in (True, False):
        cases[f"iou_similarity_{'norm' if norm else 'pixels'}"] = (
            "iou_similarity",
            {"X": [feed(_boxes(rng, 5, 1.0 if norm else 30.0), [[3, 2]])],
             "Y": [feed(_boxes(rng, 7, 1.0 if norm else 30.0))]},
            {"box_normalized": norm}, ("Out",))

    # distances: tie-free uniforms, some under the matcher's epsilon
    dist = rng.uniform(0.0, 1.0, (10, 6)).astype(np.float32)
    dist[rng.uniform(size=dist.shape) < 0.2] = 0.0
    for name, lens, attrs in (
            ("bipartite", [[3, 7]], {"match_type": "bipartite"}),
            ("bipartite_ragged", [[1, 2, 7]], {"match_type": "bipartite"}),
            ("per_prediction", [[4, 6]],
             {"match_type": "per_prediction", "dist_threshold": 0.3})):
        cases[f"match_{name}"] = (
            "bipartite_match", {"DistMat": [feed(dist, lens)]}, attrs,
            ("ColToRowMatchIndices", "ColToRowMatchDist"))

    match = np.array([[0, -1, 2, 1, -1, -1], [-1, 1, 0, -1, -1, 1]],
                     np.int32)
    labels = rng.randint(1, 5, (5, 1, 1)).astype(np.int64)
    cases["target_assign_labels_mask"] = (
        "target_assign",
        {"X": [feed(labels, [[3, 2]])], "MatchIndices": [feed(match)],
         "NegIndices": [feed(np.array([[0, 1, 0, 0, 1, 0],
                                       [1, 0, 0, 1, 0, 0]], np.int32))]},
        {"mismatch_value": 0}, ("Out", "OutWeight"))
    cases["target_assign_boxes"] = (
        "target_assign",
        {"X": [feed(_f32(rng, 5, 6, 4), [[3, 2]])],
         "MatchIndices": [feed(match)]},
        {"mismatch_value": 0}, ("Out", "OutWeight"))
    cases["target_assign_neg_lod"] = (
        "target_assign",
        {"X": [feed(labels, [[3, 2]])], "MatchIndices": [feed(match)],
         "NegIndices": [feed(np.array([[1], [4], [0], [3], [4]], np.int32),
                             [[2, 3]])]},
        {"mismatch_value": 7}, ("Out", "OutWeight"))

    n, m = 3, 12
    mmatch = np.full((n, m), -1, np.int32)
    for i, k in enumerate((1, 2, 0)):
        mmatch[i, rng.choice(m, k, replace=False)] = 0
    for name, attrs, with_loc in (
            ("mine", {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5}, False),
            ("mine_sample_size", {"neg_pos_ratio": 2.0,
                                  "neg_dist_threshold": 0.6,
                                  "sample_size": 4}, True)):
        inputs = {"ClsLoss": [feed(rng.permutation(n * m).reshape(n, m)
                                   .astype(np.float32) / 7.0)],
                  "MatchIndices": [feed(mmatch)],
                  "MatchDist": [feed(rng.uniform(0, 1, (n, m))
                                     .astype(np.float32))]}
        if with_loc:
            inputs["LocLoss"] = [feed(rng.uniform(0, 2, (n, m))
                                      .astype(np.float32))]
        cases[name] = ("mine_hard_examples", inputs,
                       dict(attrs, mining_type="max_negative"),
                       ("UpdatedMatchIndices", "NegIndices"))

    nms = dict(score_threshold=0.05, nms_top_k=10, keep_top_k=-1,
               nms_threshold=0.4, normalized=True, nms_eta=1.0,
               background_label=0)
    for name, inp, over in (
            ("nms", _nms_inputs(rng), {}),
            ("nms_eta", _nms_inputs(rng),
             dict(nms_threshold=0.7, nms_eta=0.8, nms_top_k=-1)),
            ("nms_keep_top_k", _nms_inputs(rng), dict(keep_top_k=5)),
            ("nms_pixels", _nms_inputs(rng, scale=60.0),
             dict(normalized=False, background_label=-1)),
            ("nms_none_kept", _nms_inputs(rng), dict(score_threshold=2.0))):
        cases[name] = ("multiclass_nms",
                       {"BBoxes": [feed(inp[0])], "Scores": [feed(inp[1])]},
                       dict(nms, **over), ("Out",))

    rois = np.array([[0.0, 0.0, 7.0, 5.0],        # the whole map of image 0
                     [3.2, 1.6, 18.5, 14.0],      # past the map
                     [1.0, 2.0, 2.4, 3.0],        # smaller than the bins
                     [40.0, 30.0, 50.0, 44.0],    # outside: every bin empty
                     [2.0, 0.4, 11.0, 9.9]], np.float32)
    for name, scale, ph, pw in (("roi_pool", 1.0, 2, 3),
                                ("roi_pool_scaled", 0.5, 3, 2)):
        cases[name] = (
            "roi_pool",
            {"X": [feed(_f32(rng, 2, 3, 6, 8), None, True)],
             "ROIs": [feed(rois / scale, [[2, 3]])]},
            dict(spatial_scale=scale, pooled_height=ph, pooled_width=pw),
            ("Out",))
    cases["polygon_box_transform"] = (
        "polygon_box_transform", {"Input": [feed(_f32(rng, 2, 8, 3, 4))]},
        {}, ("Output",))
    for axis in (0, 1, 2):
        cases[f"flatten_axis{axis}"] = (
            "flatten", {"X": [feed(_f32(rng, 2, 3, 4), None, True)]},
            {"axis": axis}, ("Out",))
    for mu in (0.0, 0.9):
        cases[f"rmsprop_momentum{mu}"] = (
            "rmsprop",
            {"Param": [feed(_f32(rng, 4, 3))], "Grad": [feed(_f32(rng, 4, 3))],
             "MeanSquare": [feed(np.abs(_f32(rng, 4, 3)))],
             "Moment": [feed(_f32(rng, 4, 3))],
             "LearningRate": [const(np.array([0.01], np.float32))]},
            dict(decay=0.95, epsilon=1e-6, momentum=mu),
            ("ParamOut", "MeanSquareOut", "MomentOut"))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_detection_op_matches_reference(name):
    compare_with_reference(CASES[name])


def test_roi_pool_memory_is_the_output_and_the_map():
    """The port's roi_pool allocates nothing of the reference's ``[R, C,
    ph, pw, H, W]`` mask: at a 50 x 84 map with 64 RoIs and 7 x 7 bins its
    largest tensor is the output's index, R·C·ph·pw."""
    import torch

    from paddle_tpu_torch.ops import detection_ops as do

    rng = np.random.RandomState(0)
    x = torch.from_numpy(_f32(rng, 1, 16, 50, 84))
    rois = _boxes(rng, 64, 800.0)
    hs, he, ws, we = do._roi_bins(rois, np.zeros(64, np.int64), 1 / 16.0,
                                  7, 7, 50, 84)
    seen = []
    real = torch.nn.functional.max_pool2d

    def pool(*a, **k):
        out = real(*a, **k)
        seen.append(max(t.numel() for t in out))
        return out

    torch.nn.functional.max_pool2d = pool
    try:
        arg = do._roi_argmax(x, np.zeros(64, np.int64), hs, he, ws, we)
    finally:
        torch.nn.functional.max_pool2d = real
    assert arg.numel() == 64 * 7 * 7 * 16
    assert max(seen) <= x.numel()


def test_host_ops_read_their_inputs_as_they_stand():
    """``to_host`` reads CPU tensors without a device read and keeps
    dtypes, and it reads a host op's output as it stands: a write in place
    after the op made it (a scope ``set``, ``io.load_vars``) is seen.  The
    array here is not contiguous, so ``to_device`` copies it and the write
    cannot reach it."""
    import torch

    from paddle_tpu_torch.ops import detection_ops as do

    do.reset_stats()
    arr = np.arange(6, dtype=np.int32).reshape(3, 2).T
    t = do.to_device(arr, "cpu")
    a, b, c = do.to_host(t, torch.ones(2, dtype=torch.float32), None)
    assert a.dtype == np.int32 and (a == arr).all()
    assert b.dtype == np.float32 and c is None
    t.zero_()
    (a,) = do.to_host(t)
    assert (a == 0).all() and (arr != 0).any()
    assert do.stats["host_reads"] == 0


def test_grad_sum_with_a_missing_partial_matches_reference():
    """A detection op whose inputs take no grad (``iou_similarity`` here;
    ``generate_proposals`` on the R-CNN path) still gets a grad op, which
    gives no partial: the accumulating ``sum`` then holds one input.  Its
    output must not pass for that input updated in place (the Executor
    refused ``mul_grad``'s read of the bias grad's view of it); the input
    grad equals the reference's."""
    import paddle_tpu.fluid as rf
    import paddle_tpu_torch.fluid as tf
    from paddle_tpu_torch.models.params import load_reference_params

    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(3, 4).astype(np.float32),
            "prior": np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)}
    grads, init = {}, None
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[4], dtype="float32",
                                stop_gradient=False)
            prior = pkg.layers.data(name="prior", shape=[4],
                                    dtype="float32")
            boxes = pkg.layers.fc(x, 4)
            iou = pkg.layers.iou_similarity(boxes, prior)
            pkg.append_backward(pkg.layers.elementwise_add(
                pkg.layers.reduce_sum(iou), pkg.layers.reduce_sum(boxes)))
        types = [op.type for op in main.global_block().ops]
        assert types[types.index("iou_similarity_grad") + 1] == "sum"
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        grads[pkg] = np.asarray(exe.run(main, feed=feed,
                                        fetch_list=["x@GRAD"],
                                        scope=scope)[0])
    np.testing.assert_allclose(grads[tf], grads[rf], rtol=1e-5, atol=1e-6)
