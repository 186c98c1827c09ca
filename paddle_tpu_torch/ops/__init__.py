"""PyTorch op implementations, registered by importing their modules
(counterpart of ``paddle_tpu/ops``)."""

from . import (activation_ops, decode_ops, loss_ops,  # noqa: F401
               math_ops, nn_ops, optimizer_ops, random_ops, reduce_ops,
               shape_ops)
from .registry import REGISTRY, get_op_def, is_registered, register_op

__all__ = ["REGISTRY", "get_op_def", "is_registered", "register_op"]
