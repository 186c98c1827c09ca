"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``):
accuracy, auc and chunk_eval."""

from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc", "chunk_eval"]


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k of ``input`` + the accuracy op: the share of rows whose label
    is among the k largest."""
    helper = LayerHelper("accuracy")
    from .nn import topk

    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    acc_out.shape = (1,)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1):
    """Streaming AUC of the positive-class probability ``input[:, -1]``:
    (the AUC so far, [StatPos, StatNeg]), the bucket counts persistable
    float32 ``[num_thresholds + 1]`` vars that start at 0."""
    helper = LayerHelper("auc")
    stats = []
    for _ in range(2):
        stat = helper.create_global_variable(
            persistable=True, dtype="float32", shape=[num_thresholds + 1])
        helper.set_variable_initializer(stat, ConstantInitializer(0.0))
        stats.append(stat)
    stat_pos, stat_neg = stats
    auc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    auc_out.shape = (1,)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label], "StatPos": [stat_pos],
                "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """A batch's chunk precision, recall and F1, and its int64 counts of
    inferred, labelled and correct chunks (for a running evaluator)."""
    helper = LayerHelper("chunk_eval", **locals())
    precision, recall, f1 = (
        helper.create_variable_for_type_inference("float32")
        for _ in range(3))
    num_infer, num_label, num_correct = (
        helper.create_variable_for_type_inference("int64")
        for _ in range(3))
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1], "NumInferChunks": [num_infer],
                 "NumLabelChunks": [num_label],
                 "NumCorrectChunks": [num_correct]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, num_infer, num_label, num_correct
