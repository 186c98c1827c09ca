"""paddle_tpu_torch — the Fluid surface of ``paddle_tpu`` on PyTorch and CUDA.

A second implementation of the same Program IR, built by the same builder
calls, executed eagerly op by op with PyTorch on an NVIDIA card (Hopper,
``sm_90a``).  Every Pallas kernel the JAX package wrote for the TPU gets a
hand-written CUDA kernel here (``csrc/``), with a plain PyTorch version of
the same function beside it for CPU tensors.

It carries serving (the paged continuous-batching ``DecodeEngine``, with
speculative decoding), training (Transformer and ResNet through
``fluid.Executor``, in fp32 and mixed precision, step by step or as CUDA
graphs), evaluation, checkpoints in the JAX package's format
(``fluid.io``), the inference predictor (``paddle_tpu_torch.inference``),
the training machinery (``fluid.Trainer`` with serial checkpoints,
``fluid.guardian``, ``fluid.fault``) and the input side (``reader``,
``dataset``, the checkpointable ``data`` pipeline).
Entry points run on the card (``CUDAPlace(0)``) unless the caller passes
``CPUPlace()``.
"""

from . import fluid  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from . import data  # noqa: F401

batch = reader.batch

__all__ = ["fluid", "reader", "dataset", "data", "batch"]
