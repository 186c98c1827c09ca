"""paddle_tpu_torch — the Fluid surface of ``paddle_tpu`` on PyTorch and CUDA.

A second implementation of the same Program IR, built by the same builder
calls, executed eagerly op by op with PyTorch on an NVIDIA card (Hopper,
``sm_90a``).  Every Pallas kernel the JAX package wrote for the TPU gets a
hand-written CUDA kernel here (``csrc/``), with a plain PyTorch version of
the same function beside it for CPU tensors.

This first slice carries the serving path: the paged continuous-batching
``DecodeEngine`` over the step-form ``DecodeModel``.  Entry points run on the
card (``CUDAPlace(0)``) unless the caller passes ``CPUPlace()``.
"""

from . import fluid  # noqa: F401

__all__ = ["fluid"]
