"""PyTorch op implementations, registered by importing their modules
(counterpart of ``paddle_tpu/ops``)."""

from . import (activation_ops, attention_ops, decode_ops,  # noqa: F401
               detection_ops, loss_ops, math_ops, metric_ops, misc_ops,
               moe_ops, nn_ops, optimizer_ops, pipeline_ops, quant_ops,
               random_ops, rcnn_ops, reduce_ops, rnn_ops, sequence_ops,
               shape_ops, struct_loss_ops, transformer_ops)
from .registry import REGISTRY, get_op_def, is_registered, register_op

__all__ = ["REGISTRY", "get_op_def", "is_registered", "register_op"]
