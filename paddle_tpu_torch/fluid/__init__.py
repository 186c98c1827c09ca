"""paddle_tpu_torch.fluid — the Fluid API on PyTorch (counterpart of
``paddle_tpu.fluid``).  ``Executor()`` runs on the card unless given a
place; ``CPUPlace()`` runs the plain PyTorch versions of every op."""

# ops must register before any program executes
from .. import ops as _ops  # noqa: F401

from . import amp
from . import core
from .core import CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace
from . import framework
from .framework import (Program, Operator, Parameter, Variable,
                        default_main_program, default_startup_program,
                        name_scope, program_guard)
from . import executor
from .executor import Executor, Scope, global_scope, scope_guard
from . import initializer
from . import layers
from . import nets
from . import unique_name
from . import backward
from . import clip
from . import optimizer
from . import regularizer
from . import fault
from . import guardian
from .guardian import NumericsTripped
from . import prefetch
from .prefetch import DevicePrefetcher
from .backward import append_backward, calc_gradient
from .param_attr import ParamAttr, WeightNormParamAttr
from . import average
from . import lod_tensor
from . import selected_rows
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
from .data_feeder import DataFeeder
from . import io
from .io import (save_vars, save_params, save_persistables, load_vars,
                 load_params, load_persistables, save_inference_model,
                 load_inference_model, get_inference_program)
from . import ir
from . import parallel_executor
from .parallel_executor import (BuildStrategy, ExecutionStrategy,
                                ParallelExecutor)
from . import transpiler
from . import contrib
from . import metrics
from . import evaluator
from .transpiler import (DistributeTranspiler, InferenceTranspiler,
                         memory_optimize, release_memory)
from . import trainer
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, Inferencer, Trainer)
from . import recordio_writer

Tensor = framework.Variable

__all__ = [
    "amp", "core", "framework", "executor", "initializer", "layers", "nets",
    "unique_name",
    "backward", "clip", "optimizer", "regularizer", "append_backward",
    "calc_gradient",
    "Program", "Operator", "Parameter", "Variable", "default_main_program",
    "default_startup_program", "program_guard", "name_scope", "Executor",
    "Scope",
    "global_scope", "scope_guard", "CPUPlace", "CUDAPlace", "TPUPlace",
    "ParamAttr", "WeightNormParamAttr", "average", "guardian",
    "NumericsTripped", "prefetch", "recordio_writer",
    "DevicePrefetcher",
    "CUDAPinnedPlace", "io", "ir", "transpiler", "InferenceTranspiler",
    "memory_optimize", "release_memory",
    "DataFeeder", "contrib", "metrics", "evaluator", "selected_rows",
    "lod_tensor", "LoDTensor",
    "create_lod_tensor",
    "create_random_int_lodtensor", "save_vars", "save_params",
    "save_persistables", "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model", "get_inference_program",
    "fault", "trainer", "Trainer", "Inferencer", "CheckpointConfig",
    "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
    "parallel_executor", "ParallelExecutor", "ExecutionStrategy",
    "BuildStrategy", "DistributeTranspiler",
]
