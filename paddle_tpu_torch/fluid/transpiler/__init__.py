"""Transpilers (counterpart of ``paddle_tpu/fluid/transpiler/``): the
inference transpiler.  The distribute, int8-weight and memory transpilers
are not ported yet."""

from .inference_transpiler import InferenceTranspiler

__all__ = ["InferenceTranspiler"]
