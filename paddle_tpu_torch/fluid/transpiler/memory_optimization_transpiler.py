"""Memory-optimization transpiler (counterpart of
``paddle_tpu/fluid/transpiler/memory_optimization_transpiler.py``):
``memory_optimize`` and ``release_memory`` return the program unchanged,
so scripts that call them run as they are.  There is nothing for them to
rewrite: the Executor already frees every intermediate after its last
reader (the liveness-freed intermediates of ``fluid/executor.py``'s
``BlockPlan.release``), and the update ops write the parameters and
their state in place."""

from __future__ import annotations

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    if print_log:
        print("memory_optimize: nothing to do (the Executor frees each "
              "intermediate after its last reader)")
    return input_program


def release_memory(input_program, skip_opt_set=None):
    return input_program
