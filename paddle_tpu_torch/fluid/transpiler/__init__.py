"""Transpilers (counterpart of ``paddle_tpu/fluid/transpiler/``): the
inference transpiler and the weight-only int8 transpiler.  The distribute
and memory transpilers are not ported yet."""

from .inference_transpiler import InferenceTranspiler
from .int8_transpiler import Int8WeightTranspiler

__all__ = ["InferenceTranspiler", "Int8WeightTranspiler"]
