"""The detection paths of the port against the JAX package, on the CPU,
with ``chip_smoke``'s builders making the same programs in both packages:

 - ``chip_smoke.mobilenet_ssd`` (upstream ``object_detection``'s
   MobileNet-SSD) at a narrow ``scale``: the same op types in order, the
   same attrs and the same parameters in the main, startup and test
   programs, and 1,917 priors in both;
 - the small SSD (``chip_smoke.small_ssd``: ``tests/test_ssd.py``'s shape
   under ``ssd_loss``, RMSProp on ``piecewise_decay`` and ``L2Decay``) from
   the reference's initial scope (``load_reference_params``): 5 steps'
   losses within rtol 1e-5 at step 0 and 1e-4 after, the loss falling;
   then from the reference's trained state, the test clone's
   ``detection_output`` rows (labels exactly, scores and boxes within
   1e-5), its LoD, and ``detection_map``'s mAP equal the reference's;
 - a training step of the small SSD reads nothing back to the host (no
   ``item`` / ``tolist`` / ``numpy`` / ``bool`` of a tensor, no host op);
 - ``chip_smoke.rcnn_heads`` at ``chip_smoke.RCNN_SMALL`` with the
   samplers drawing (seeded, both counters reset): 2 steps' losses within
   the same tolerances, and the same sampled RoIs and labels;
 - the RPN alone with its convs drawn and trained (``RPN_SMALL``): 3
   steps' RPN losses, ``rpn_target_assign``'s outputs and every grad;
 - ``chip_smoke.compare_decodes`` (the card-vs-CPU decode check) passes
   decodes that differ by near-ties and refuses other differences;
 - ``fluid.layers`` exports every name of the reference's
   ``layers.detection.__all__``, and the registry holds every op type of
   the reference's ``detection_ops.py`` and ``rcnn_ops.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.ops import rcnn_ops as ref_rcnn
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params
from paddle_tpu_torch.ops import rcnn_ops as port_rcnn

STEPS = 5
LOSS_RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    ref_rcnn._SAMPLER_CALLS[0] = port_rcnn._SAMPLER_CALLS[0] = 0
    yield


def _ops(prog):
    return [(op.type, {k: v for k, v in op.attrs.items()
                       if not k.startswith("op_")})
            for op in prog.global_block().ops]


def _params(prog):
    return [(p.name, tuple(p.shape), p.trainable)
            for p in prog.global_block().all_parameters()]


def _snapshot(scope, startup):
    return {v.name: np.array(scope.get(v.name)).copy()
            for v in startup.list_vars() if v.persistable}


def test_mobilenet_ssd_program_matches_reference():
    ref = chip_smoke.mobilenet_ssd(rf, scale=0.25)
    port = chip_smoke.mobilenet_ssd(tf, scale=0.25)
    assert port["priors"] == ref["priors"] == chip_smoke.SSD_PRIORS
    for key in ("main", "startup", "test"):
        assert _ops(port[key]) == _ops(ref[key]), key
    assert _params(port["main"]) == _params(ref["main"])
    types = [t for t, _ in _ops(port["main"])]
    assert types.count("rmsprop") == len(_params(port["main"]))
    for t in ("prior_box", "iou_similarity", "bipartite_match",
              "mine_hard_examples", "target_assign", "box_coder", "flatten"):
        assert t in types, t
    test_types = [t for t, _ in _ops(port["test"])]
    assert "multiclass_nms" in test_types
    assert test_types[-1] == "detection_map"


def _run_small(pkg, progs, feeds, init):
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(progs["startup"], scope=scope)
    if init is None:
        init = _snapshot(scope, progs["startup"])
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    losses = np.array([float(np.asarray(exe.run(
        progs["main"], feed=feeds[k % len(feeds)],
        fetch_list=[progs["loss"]], scope=scope)[0]).reshape(-1)[0])
        for k in range(STEPS)])
    return exe, scope, losses, init


def _small_feeds(n=2):
    rng = np.random.RandomState(3)
    return [chip_smoke.ssd_batch(
        rng, batch=chip_smoke.SSD_SMALL_BATCH,
        image_shape=chip_smoke.SSD_SMALL_IMAGE,
        num_classes=chip_smoke.SSD_SMALL_CLASSES, boxes=(1, 3))
        for _ in range(n)]


def test_small_ssd_trains_and_decodes_as_reference():
    feeds = _small_feeds()
    progs, runs, init = {}, {}, None
    for pkg in (rf, tf):
        progs[pkg] = chip_smoke.small_ssd(pkg)
        exe, scope, losses, init = _run_small(pkg, progs[pkg], feeds, init)
        runs[pkg] = (exe, scope, losses)
    np.testing.assert_array_less(
        np.abs(runs[tf][2] - runs[rf][2]) / np.abs(runs[rf][2]), LOSS_RTOL)
    assert runs[tf][2][-1] < runs[tf][2][0]

    trained = _snapshot(runs[rf][1], progs[rf]["startup"])
    load_reference_params(runs[tf][1], trained, tf.CPUPlace())
    got = {}
    for pkg in (rf, tf):
        exe, scope, _ = runs[pkg]
        p = progs[pkg]
        got[pkg] = [exe.run(p["test"], feed=f, scope=scope,
                            fetch_list=[p["nmsed"], p["map"]],
                            return_numpy=False) for f in _small_feeds(3)]
    for (rn, rm), (tn, tm) in zip(got[rf], got[tf]):
        rows, want = np.asarray(tn), np.asarray(rn)
        assert tn.lod() == rn.lod() and rows.shape == want.shape
        assert rows.shape[1] == 6 and rows.shape[0] > 0
        np.testing.assert_array_equal(rows[:, 0], want[:, 0])
        np.testing.assert_allclose(rows[:, 1:], want[:, 1:], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(tm), np.asarray(rm),
                                   rtol=1e-6)


def test_small_ssd_step_reads_nothing_back():
    """A training step's ops never read a tensor's values on the host: the
    matcher's loop count comes from the LoD, its "anything left" test and
    the mining stay tensors, the priors are cached."""
    progs = chip_smoke.small_ssd(tf)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(progs["startup"], scope=scope)
    feed = _small_feeds(1)[0]
    exe.run(progs["main"], feed=feed, fetch_list=[progs["loss"]],
            scope=scope)

    def refuse(*a, **k):
        raise AssertionError("a host read inside a training step")

    names = ("item", "tolist", "numpy", "__bool__", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        out = exe.run(progs["main"], feed=feed, fetch_list=[progs["loss"]],
                      scope=scope, return_numpy=False)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    assert np.isfinite(float(out[0].reshape(-1)[0]))
    assert not any(op.type in ("multiclass_nms", "detection_map")
                   for op in progs["main"].global_block().ops)


def test_small_rcnn_heads_train_as_reference():
    small = dict(chip_smoke.RCNN_SMALL, use_random=True)
    feed = chip_smoke.rcnn_feed(np.random.RandomState(7),
                                **chip_smoke.RCNN_SMALL_FEED)
    out, init = {}, None
    for pkg, mod in ((rf, ref_rcnn), (tf, port_rcnn)):
        mod._SAMPLER_CALLS[0] = 0
        progs = chip_smoke.rcnn_heads(pkg, **small)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(progs["startup"], scope=scope)
        if init is None:
            init = _snapshot(scope, progs["startup"])
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        out[pkg] = [exe.run(progs["main"], feed=feed, scope=scope,
                            fetch_list=[progs["loss"], progs["rois"],
                                        progs["labels"]])
                    for _ in range(2)]
    for r, p in zip(out[rf], out[tf]):
        np.testing.assert_allclose(np.asarray(p[0]), np.asarray(r[0]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(p[1]), np.asarray(r[1]))
        np.testing.assert_array_equal(np.asarray(p[2]), np.asarray(r[2]))
    assert (np.asarray(out[tf][0][2]) > 0).any()     # some foreground RoIs


def test_small_rpn_trains_as_reference():
    """The RPN alone (``chip_smoke.RPN_SMALL``: its convs drawn and
    trained, the sampler drawing, seeded) for 3 steps from the reference's
    initial state: the two RPN losses, ``rpn_target_assign``'s outputs and
    every parameter's and the feature map's grad, each step, by
    ``chip_smoke.check_rpn_step`` (integers equal; floats within rtol 1e-5
    at step 0 and 1e-4 after, of each value plus a tensor's largest
    magnitude)."""
    small = dict(chip_smoke.RPN_SMALL, use_random=True)
    feed = chip_smoke.rcnn_feed(np.random.RandomState(7),
                                **chip_smoke.RCNN_SMALL_FEED)
    out, init, names = {}, None, None
    for pkg, mod in ((rf, ref_rcnn), (tf, port_rcnn)):
        mod._SAMPLER_CALLS[0] = 0
        progs = chip_smoke.rcnn_heads(pkg, **small)
        names = chip_smoke.rpn_fetches(progs)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(progs["startup"], scope=scope)
        if init is None:
            init = _snapshot(scope, progs["startup"])
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        out[pkg] = [exe.run(progs["main"], feed=feed, scope=scope,
                            fetch_list=names) for _ in range(3)]
    assert len(progs["params"]) == chip_smoke.RPN_SMALL_MOMENTUM_TENSORS
    for step, (r, p) in enumerate(zip(out[rf], out[tf])):
        chip_smoke.check_rpn_step(f"step {step}", names, r, p,
                                  1e-5 if step == 0 else 1e-4)
    grads = [np.asarray(v) for n, v in zip(names, out[tf][0])
             if n.endswith("@GRAD")]
    assert all(np.abs(g).max() > 0 for g in grads)   # every conv learns


def test_rpn_check_catches_a_wrong_grad():
    """``chip_smoke.check_rpn_step`` refuses an integer off by one and a
    grad off by more than its tolerance, and passes one within it."""
    names = ["idx", "w@GRAD"]
    want = [np.array([1, 2], np.int32), np.array([1e-3, 0.0], np.float32)]
    ok = [want[0], want[1] + np.float32(1e-9)]
    chip_smoke.check_rpn_step("t", names, want, ok, 1e-5)
    with pytest.raises(AssertionError, match="idx"):
        chip_smoke.check_rpn_step("t", names, want,
                                  [want[0] + 1, want[1]], 1e-5)
    with pytest.raises(AssertionError, match="w@GRAD"):
        chip_smoke.check_rpn_step("t", names, want,
                                  [want[0], want[1] * 1.01], 1e-5)


def _nms_rows(boxes, scores, attrs):
    main = tf.Program()
    with tf.program_guard(main, tf.Program()):
        b = tf.layers.data(name="b", shape=list(boxes.shape[1:]),
                           dtype="float32")
        s = tf.layers.data(name="s", shape=list(scores.shape[1:]),
                           dtype="float32")
        out = tf.layers.multiclass_nms(b, s, **attrs)
    (o,) = tf.Executor(tf.CPUPlace()).run(
        main, feed={"b": boxes, "s": scores}, fetch_list=[out],
        return_numpy=False)
    return np.asarray(o), o.lod()[0]


def test_decode_comparison_explains_near_ties_only():
    """``chip_smoke.compare_decodes`` (``detect_ssd``'s card-vs-CPU decode
    check) passes two NMS decodes whose inputs differ by less than its
    ``atol``, on scores rounded to a grid so that many tie; it refuses a
    decode that lost a row no near-tie explains, and one whose rows of
    distant scores swapped."""
    rng = np.random.RandomState(0)
    n, c, m, atol = 3, 5, 200, 1e-5
    attrs = dict(score_threshold=0.01, nms_top_k=40, keep_top_k=30,
                 nms_threshold=0.45, background_label=0)
    causes = {}
    for _ in range(3):
        xy = rng.uniform(0, 0.8, (n, m, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (n, m, 2))],
                               -1).astype(np.float32)
        scores = (np.round(rng.uniform(0, 0.2, (n, c, m)) * 300) / 300
                  ).astype(np.float32)
        near = (scores + rng.uniform(-atol / 2, atol / 2, scores.shape)
                ).astype(np.float32)
        a = _nms_rows(boxes, scores, attrs)
        b = _nms_rows((boxes + rng.uniform(-atol / 4, atol / 4, boxes.shape)
                       ).astype(np.float32), near, attrs)
        rep = chip_smoke.compare_decodes(a, b, (scores, near), attrs, atol)
        for k, v in rep.items():
            if isinstance(v, int):
                causes[k] = causes.get(k, 0) + v
    assert causes["reordered_pairs"] > 0 and causes["keep_top_k"] > 0
    rows, lod = a
    lost = (np.delete(rows, 0, 0), (0,) + tuple(x - 1 for x in lod[1:]))
    with pytest.raises(AssertionError, match="kept on the card only"):
        chip_smoke.compare_decodes(a, lost, (scores, scores), attrs, atol)
    swapped = rows.copy()
    swapped[[0, lod[1] - 1]] = swapped[[lod[1] - 1, 0]]
    with pytest.raises(AssertionError, match="other order"):
        chip_smoke.compare_decodes(a, (swapped, lod), (scores, scores),
                                   attrs, atol)


def test_layers_and_registry_cover_the_reference():
    from paddle_tpu.fluid.layers import detection as ref_detection
    from paddle_tpu.ops import detection_ops as ref_ops
    from paddle_tpu.ops.registry import REGISTRY as REF
    from paddle_tpu_torch.ops.registry import REGISTRY

    missing = [n for n in ref_detection.__all__ if not hasattr(tf.layers, n)]
    assert not missing, missing
    ported = {t for t, d in REF.items()
              if d.fn.__module__ in (ref_ops.__name__, ref_rcnn.__name__)}
    assert len(ported) == 14 and ported <= set(REGISTRY)
    assert {"flatten", "rmsprop"} <= set(REGISTRY) and len(REGISTRY) >= 145
