"""Transpilers (counterpart of ``paddle_tpu/fluid/transpiler/``): the
distribute transpiler (which records the topology ``ParallelExecutor``
runs over), the inference transpiler, the weight-only int8 transpiler and
the memory transpiler (which has nothing to rewrite)."""

from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .inference_transpiler import InferenceTranspiler
from .int8_transpiler import Int8WeightTranspiler
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "InferenceTranspiler", "Int8WeightTranspiler", "memory_optimize",
           "release_memory", "HashName", "RoundRobin"]
