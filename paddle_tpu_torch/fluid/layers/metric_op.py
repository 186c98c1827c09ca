"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``):
accuracy."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


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
