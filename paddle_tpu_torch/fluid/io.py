"""Checkpoint and model save / load (counterpart of
``paddle_tpu/fluid/io.py``), in the reference's on-disk format:

 - one ``np.save`` file per variable inside ``dirname``, named after it,
   written with ``allow_pickle=False`` (or, with ``filename=``, one
   ``np.savez`` file of them all);
 - ``__model__``: a pickled ``{"program_blob", "feed_names",
   "fetch_names"}``, the blob from ``Program.serialize_to_string``.

So a per-variable checkpoint either package writes loads in the other.
``__model__`` does not cross: its blob names the writer's classes, and
this package unpickles only its own (``framework.safe_loads``).

Saving is one host copy of each tensor (``detach().cpu().numpy()``).
A bfloat16 persistable is refused: numpy has no bfloat16, and the
reference's ``np.save`` of one writes raw two-byte voids.

Loading writes each value in place where the scope already holds a tensor
of that name (``copy_``: a window's buffers or an engine's graphs keep
reading the scope's own tensors), or puts a new tensor on the executor's
device.  Every file is read, and every shape and dtype checked, before
anything is written.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import core
from .executor import global_scope
from .framework import (Parameter, Program, Variable, default_main_program,
                        safe_loads)

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "get_inference_program", "snapshot_vars",
    "write_var_files",
]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _resolve_vars(main_program, predicate, vars):
    main_program = main_program or default_main_program()
    if vars is not None:
        return [main_program.global_block()._var_recursive(v)
                if isinstance(v, str) else v for v in vars]
    return [v for v in main_program.list_vars() if predicate(v)]


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    predicate = predicate or is_persistable
    var_list = _resolve_vars(main_program, predicate, vars)
    snap = snapshot_vars(global_scope(), var_list)
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        with open(os.path.join(dirname, filename), "wb") as f:
            np.savez(f, **snap)
        return
    write_var_files(dirname, snap)


SHARDED_LATER = "ROADMAP.md queue 1 item 12b, step 3 (sharded serials)"


class ShardedScopeError(NotImplementedError):
    """The scope holds the rank's shards of a var (a ``ParallelExecutor``
    over a tp or fsdp mesh): a file of them would not be the var."""


def check_unsharded(scope, names) -> None:
    """Raise :class:`ShardedScopeError` if ``scope`` holds a shard of any
    of ``names`` (``ShardedTrainStep.place_state`` marks them)."""
    shards = getattr(scope, "_shards", None) or {}
    held = [n for n in names if n in shards]
    if held:
        label, spec = shards[held[0]]
        raise ShardedScopeError(
            f"the scope holds this rank's shard of {held[0]!r} (mesh "
            f"{label}, spec {spec}) and of {len(held) - 1} more; saving a "
            f"sharded scope comes with {SHARDED_LATER}")


def snapshot_vars(scope, var_list) -> dict:
    """Host-side ``{name: ndarray}`` of the vars present in ``scope``;
    raises ``TypeError`` on a bfloat16 one before copying anything, and
    :class:`ShardedScopeError` on a scope that holds shards."""
    check_unsharded(scope, [v.name for v in var_list])
    vals = [(v.name, scope.get(v.name)) for v in var_list]
    vals = [(n, t) for n, t in vals if t is not None]
    for name, t in vals:
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            raise TypeError(
                f"cannot save {name!r}: it is bfloat16, which the .npy "
                f"format cannot hold (numpy has no bfloat16); keep "
                f"persistables in float32")
    return {name: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for name, t in vals}


def write_var_files(dirname, snapshot: dict) -> None:
    """One ``np.save`` file per var (``load_vars`` is its reader), each
    write under bounded transient retry (``fluid.retry``)."""
    from . import fault as _fault
    from .retry import retry_io

    for name, arr in snapshot.items():
        path = os.path.join(dirname, name)

        def _write(path=path, arr=arr):
            _fault.io_delay()
            _fault.io_error(path, "write")
            with open(path, "wb") as f:
                np.save(f, arr, allow_pickle=False)

        retry_io(_write, what="ckpt.var_write")


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, None, is_persistable, filename)


def _read_var_files(dirname, var_list) -> dict:
    from . import fault as _fault
    from .retry import retry_io

    arrays = {}
    for v in var_list:
        path = os.path.join(dirname, v.name)
        if not os.path.exists(path):
            # as the reference's load op: an absent file is an error, not
            # a var left at its random init
            raise IOError(
                f"load_vars: no saved file for variable '{v.name}' in "
                f"{dirname} (program/name mismatch with the checkpoint?)")

        def _read(path=path):
            # an OSError retries; a corrupt payload's ValueError does not
            _fault.io_error(path, "read")
            with open(path, "rb") as f:
                return np.load(f, allow_pickle=False)

        arrays[v.name] = retry_io(_read, what="ckpt.var_read")
    return arrays


def _install(scope, arrays: dict, device) -> None:
    """Write ``arrays`` into ``scope``: in place over a tensor of the same
    shape and dtype, else as a new tensor on ``device``; a shape or dtype
    that does not match raises before anything is written."""
    staged = []
    for name, arr in arrays.items():
        cur = scope.get(name)
        if isinstance(cur, torch.Tensor):
            if tuple(cur.shape) != tuple(arr.shape):
                raise ValueError(f"load_vars: {name} has shape "
                                 f"{tuple(arr.shape)} in the checkpoint and "
                                 f"{tuple(cur.shape)} in the scope")
            if core.convert_dtype(cur.dtype) != core.convert_dtype(arr.dtype):
                raise TypeError(f"load_vars: {name} is {arr.dtype} in the "
                                f"checkpoint and {cur.dtype} in the scope")
        else:
            cur = None
        staged.append((name, cur, arr))
    for name, cur, arr in staged:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if cur is not None:
            cur.copy_(t)
        else:
            scope.set(name, t.to(device))


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    predicate = predicate or is_persistable
    var_list = _resolve_vars(main_program, predicate, vars)
    scope = scope or global_scope()
    if filename is not None:
        with np.load(os.path.join(dirname, filename)) as data:
            arrays = {v.name: data[v.name] for v in var_list
                      if v.name in data}
    else:
        arrays = _read_var_files(dirname, var_list)
    device = executor.device if executor is not None \
        else core.torch_device(core.CUDAPlace(0))
    _install(scope, arrays, device)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program, None, is_parameter, filename,
              scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    load_vars(executor, dirname, main_program, None, is_persistable, filename,
              scope=scope)


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    pruned = main_program._prune(target_vars)
    return pruned.inference_optimize()


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """The test clone of ``main_program`` pruned to ``target_vars``, as
    ``__model__``, and every persistable it reads."""
    main_program = main_program or default_main_program()
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.clone(for_test=True)
    inference_program = inference_program._prune(target_vars)
    payload = {
        "program_blob": inference_program.serialize_to_string(),
        "feed_names": list(feeded_var_names),
        "fetch_names": [t.name for t in target_vars],
    }
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename), "wb") as f:
        pickle.dump(payload, f)
    save_persistables(executor, dirname, inference_program, params_filename)
    return [t.name for t in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch vars) of a model this package saved.
    A ``__model__`` the JAX package wrote raises ``ValueError`` (its
    program names that package's classes) and imports nothing of it."""
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename), "rb") as f:
        payload = safe_loads(f.read())
    if "program_blob" in payload:
        program = Program.parse_from_string(payload["program_blob"])
    else:  # pre-versioned __model__ files
        program = payload["program"]
    load_persistables(executor, dirname, program, params_filename,
                      scope=scope)
    fetch_vars = [program.global_block()._var_recursive(n)
                  for n in payload["fetch_names"]]
    return program, payload["feed_names"], fetch_vars
