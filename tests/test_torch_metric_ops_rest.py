"""The port's ``auc``, ``mean_iou``, ``positive_negative_pair`` and
``precision_recall`` (``paddle_tpu_torch/ops/metric_ops.py``) against the
JAX package's, on the CPU:

 - ``fluid.layers.auc`` and ``mean_iou`` emit the reference's Program;
 - ``auc`` runs 4 steps in both packages over one scope each: the bucket
   counts equal at every step (exact: counts of 1.0), the AUC within rtol
   1e-6 (a float32 sum of the trapezoids in another order), and equal to
   a numpy float64 trapezoid over the same buckets within 1e-6;
   probabilities at 0, 1 and on bucket edges included, at 4095
   thresholds (upstream's CTR default) and 200;
 - the other three through the one-op harness of
   ``test_torch_sequence_ops.py``: float outputs at rtol 1e-5 / atol
   1e-6, integer outputs equal; with and without weights and
   accumulators, equal scores, and a class no row holds.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_activation_ops_rest import _builder_program, _data
from test_torch_sequence_ops import compare_with_reference, const, feed

AUC_RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


@pytest.mark.parametrize("name", ["auc", "mean_iou"])
def test_builder_emits_reference_program(name):
    def build(pkg):
        if name == "auc":
            pkg.layers.auc(_data(pkg, "p", (2,)),
                           _data(pkg, "l", (1,), "int64"),
                           num_thresholds=200)
        else:
            pkg.layers.mean_iou(_data(pkg, "p", (1,), "int32"),
                                _data(pkg, "l", (1,), "int32"), 5)

    assert _builder_program(tf, build) == _builder_program(rf, build)


def _auc_batches(steps=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(steps):
        p = rng.uniform(size=batch).astype(np.float32)
        if step == 0:  # the ends and a bucket edge at 200 and 4095
            p[:4] = [0.0, 1.0, 0.5, np.float32(41) / np.float32(200)]
        out.append({"p": np.stack([1 - p, p], 1),
                    "l": rng.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


def _numpy_auc(pos, neg):
    pos_cum, neg_cum = np.cumsum(pos[::-1]), np.cumsum(neg[::-1])
    prev_pos = np.concatenate([[0.0], pos_cum[:-1]])
    prev_neg = np.concatenate([[0.0], neg_cum[:-1]])
    area = np.sum((neg_cum - prev_neg) * (pos_cum + prev_pos) / 2.0)
    return area / (pos_cum[-1] * neg_cum[-1])


@pytest.mark.parametrize("thresholds", [4095, 200])
def test_auc_accumulates_over_steps(thresholds):
    runs = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            value, (pos, neg) = pkg.layers.auc(
                _data(pkg, "p", (2,)), _data(pkg, "l", (1,), "int64"),
                num_thresholds=thresholds)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        runs.append([[np.array(a) for a in exe.run(
            main, feed=f, fetch_list=[value, pos, neg], scope=scope)]
            for f in _auc_batches()])
    seen = 0
    for (rv, rpos, rneg), (pv, ppos, pneg) in zip(*runs):
        seen += 16
        assert pv.dtype == rv.dtype == np.float32 and pv.shape == (1,)
        assert ppos.shape == (thresholds + 1,) and ppos.dtype == np.float32
        np.testing.assert_array_equal(ppos, rpos)
        np.testing.assert_array_equal(pneg, rneg)
        assert ppos.sum() + pneg.sum() == seen
        np.testing.assert_allclose(pv, rv, rtol=AUC_RTOL)
        np.testing.assert_allclose(
            pv[0], _numpy_auc(ppos.astype(np.float64),
                              pneg.astype(np.float64)), rtol=AUC_RTOL)


def _ints(seed, n, high, dtype=np.int32):
    return np.random.RandomState(seed).randint(0, high, n).astype(dtype)


def _f32(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _cases():
    labels = _ints(1, 40, 4)  # class 4 of 5 never occurs
    preds = _ints(2, 40, 4)
    preds[:3] = labels[:3]
    cases = {
        "mean_iou": ("mean_iou", {"Predictions": [feed(preds)],
                                  "Labels": [feed(labels)]},
                     {"num_classes": 5},
                     ("OutMeanIou", "OutWrong", "OutCorrect")),
    }
    score = _f32(3, 12, 2)
    score[4, 0] = score[5, 0]  # an equal score within a query
    query = np.array([[0]] * 6 + [[1]] * 4 + [[2]] * 2, np.int64)
    label = _ints(4, 12, 3, np.float32).reshape(-1, 1)
    label[4, 0], label[5, 0] = 0.0, 2.0
    pn = {"Score": [feed(score)], "Label": [feed(label)],
          "QueryID": [feed(query)]}
    outs = ("PositivePair", "NegativePair", "NeutralPair")
    cases["pnpair"] = ("positive_negative_pair", pn, {"column": 0}, outs)
    cases["pnpair_weighted_accumulated"] = (
        "positive_negative_pair",
        dict(pn, Weight=[feed(np.abs(_f32(5, 12, 1)))],
             AccumulatePositivePair=[const(np.array([3.0], np.float32))],
             AccumulateNegativePair=[const(np.array([1.5], np.float32))],
             AccumulateNeutralPair=[const(np.array([0.5], np.float32))]),
        {"column": 1}, outs)
    idx = _ints(6, 30, 3, np.int64).reshape(-1, 1)  # class 3 of 4 unseen
    lab = _ints(7, 30, 3, np.int64).reshape(-1, 1)
    pr = {"MaxProbs": [feed(np.abs(_f32(8, 30, 1)))],
          "Indices": [feed(idx)], "Labels": [feed(lab)]}
    pr_outs = ("BatchMetrics", "AccumMetrics", "AccumStatesInfo")
    cases["precision_recall"] = ("precision_recall", pr,
                                 {"class_number": 4}, pr_outs)
    states = np.abs(_f32(9, 4, 4)) * 5
    cases["precision_recall_weighted_states"] = (
        "precision_recall",
        dict(pr, Weights=[feed(np.abs(_f32(10, 30, 1)))],
             StatesInfo=[feed(states.astype(np.float32))]),
        {"class_number": 4}, pr_outs)
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_op_matches_reference(name):
    compare_with_reference(CASES[name])
