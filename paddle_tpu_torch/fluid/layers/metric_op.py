"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``):
accuracy and chunk_eval."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["accuracy", "chunk_eval"]


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
