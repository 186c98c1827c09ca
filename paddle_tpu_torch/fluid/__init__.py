"""paddle_tpu_torch.fluid — the Fluid API on PyTorch (counterpart of
``paddle_tpu.fluid``).  ``Executor()`` runs on the card unless given a
place; ``CPUPlace()`` runs the plain PyTorch versions of every op."""

# ops must register before any program executes
from .. import ops as _ops  # noqa: F401

from . import core
from .core import CPUPlace, CUDAPlace, TPUPlace
from . import framework
from .framework import (Program, Operator, Parameter, Variable,
                        default_main_program, default_startup_program,
                        program_guard)
from . import executor
from .executor import Executor, Scope, global_scope
from . import initializer
from . import layers
from . import unique_name
from . import backward
from . import clip
from . import optimizer
from . import regularizer
from .backward import append_backward
from .param_attr import ParamAttr

__all__ = [
    "core", "framework", "executor", "initializer", "layers", "unique_name",
    "backward", "clip", "optimizer", "regularizer", "append_backward",
    "Program", "Operator", "Parameter", "Variable", "default_main_program",
    "default_startup_program", "program_guard", "Executor", "Scope",
    "global_scope", "CPUPlace", "CUDAPlace", "TPUPlace", "ParamAttr",
]
