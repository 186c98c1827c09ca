"""Transpilers (counterpart of ``paddle_tpu/fluid/transpiler/``): the
inference transpiler, the weight-only int8 transpiler and the memory
transpiler (which has nothing to rewrite).  The distribute transpiler is
not ported yet."""

from .inference_transpiler import InferenceTranspiler
from .int8_transpiler import Int8WeightTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory

__all__ = ["InferenceTranspiler", "Int8WeightTranspiler", "memory_optimize",
           "release_memory"]
