"""Scope + Executor (counterpart of ``paddle_tpu/fluid/executor.py``).

The reference traces a whole block into one jitted XLA program.  The port
runs it eagerly, op by op, with PyTorch on the place's device:

 - ``BlockPlan`` keeps the ops a run needs (those feeding a fetch or
   writing a persistable), finds which names come from the scope, and
   which outputs anything reads: an op is told only the outputs someone
   reads, and a tensor is dropped after its last reader, so eager
   activations do not all live to the end of the step;
 - ``<type>_grad`` ops run the op's registered grad impl, or else the
   generic one (``torch.autograd.grad`` over the forward impl,
   ``ops/registry.py``);
 - persistable state lives in the :class:`Scope` as device tensors.  Ops
   whose output names equal their input names update the scope's tensor
   in place: ``kv_cache_update`` (the decode caches) and the optimizer
   ops (``ParamOut`` = ``Param``, the moments).  The reference gets the
   same effect from XLA buffer donation.  The first run of each plan
   checks that no other name read later in the run is a view of a tensor
   so updated;
 - constant ops (``assign_value``, ``fill_constant`` of non-persistables)
   run once per plan and their device tensors are reused;
 - a run of consecutive ops of one type that has a group impl
   (``ops/registry.py`` ``register_group``: momentum, adam) runs as one
   call at its first op, when their attrs are equal but for the op role
   and none reads a name another writes (``BlockPlan`` finds the runs and
   splits one where that would break): the optimizer's per-parameter
   updates become one kernel launch.  Every other op, and a run of one,
   runs on its own;
 - random ops draw from one ``torch.Generator`` per (scope, device), kept
   in the scope under ``@RNG_STATE@`` and seeded from the
   ``Program.random_seed`` of the first run that needs it; later runs,
   startup and main alike, advance it, as the reference's threaded key;
 - fetches come back as snapshots: numpy arrays (or, with
   ``return_numpy=False``, tensor copies) that the next run cannot change
   and that write nothing back into the scope (a SelectedRows grad of a
   sparse table, as in the reference, comes back as a 0-d object array
   holding it).  A fed ``torch.Tensor``
   that an op of the plan updates in place is cloned first, so the
   caller's tensor is never written; numpy feeds are always copied.

 - a training program runs guarded (``fluid/guardian.py``) while a
   guardian is armed, or when built with ``fluid.amp`` dynamic loss
   scaling: the backward seed is multiplied by the loss scale and the
   fault layer's grad-Inf injection; with a guardian armed, the ops that
   update state in place are snapshot before the first ``Optimize``-role
   op, every read-write persistable is committed as ``torch.where(ok,
   new, old)`` and the step's health goes to the guardian; a loss-scaled
   program with no guardian keeps one host read of the finite flag before
   the first ``Optimize`` op and skips those ops on overflow (bitwise the
   device gate).  The scale vars are updated either way.
 - a training program's run (or window) passes the fault layer's step
   boundary first (``fluid/fault.py``: kill-at-step, the straggler), and
   its new state passes ``fault.corrupt_state`` (the NaN injection).

``run_steps`` runs ``n`` steps as one window (the reference's ``lax.scan``
over its traced step): ``_Window`` keeps a static buffer per state name
and per feed, and ``fluid/cuda_graph.py``'s ``StepGraph`` runs the step
over them: on the card the first step eagerly, the next captured as one
CUDA graph, then one replay a step, with no host read inside (a guarded
step gates its update on the device); on the CPU every step eagerly.
The scope holds the buffers between windows.

Fetches of bfloat16 vars come back as float32 numpy arrays (exact): numpy
has no bfloat16, and the reference's ``ml_dtypes`` arrays are not available
on every host.

LoD is host metadata of a run, as in the reference's trace: a
``LoDTensor`` (or ``(array, lengths)``) feed puts its LoD, in offsets
form, in the run's env under ``<name>@LOD``; ``run_op`` hands each op its
inputs' LoDs (``ExecContext.in_lod``); an output takes the LoD the op
returns (``<slot>@LOD``), or else the reference's ShareLoD rule: when the
op's inputs carry exactly one distinct LoD, an output whose leading dim
equals that LoD's packed row count takes it.  Rebinding a name drops its
old LoD; a LoD entry is released with the last op that names its var; a
persistable's LoD stays in the scope across runs; a fetch that carries a
LoD comes back with ``return_numpy=False`` as a ``LoDTensor``.  The plan
cache keys on no LoD (each batch brings its own).  A program whose
declared data var is neither fed nor in the scope is pruned
to the fetch targets when that drops the var (``_prune_for_unfed``); and
with ``core.GLOBAL_FLAGS["check_nan_inf"]`` every run reads its new state
and fetches on the host and raises ``FloatingPointError`` naming the first
that is not finite (a sync a run: for debugging).

Control flow (``fluid/control_flow_exec.py``): ``run_op`` hands
``while``, ``conditional_block``, their grads and ``jit_beam_search`` to
their handlers, which run the sub-block's ops through ``run_op`` against
the same env.  A ``while`` op lists what its body reads as its ``X``
inputs, so ``BlockPlan``'s liveness keeps those names to the loop (and to
``while_grad``, which reads them too); the stash of pre-loop values and of
host inputs (``@WHILE_STASH@``, ``@FWD_HOST@``) are no IR names and live to
the end of the run.  Host values (numpy: counters, indices, conditions;
``ops/registry.py``) are kept as they are in the env, fetched as numpy, and
stashed by the ops whose grad reads them (``write_to_array``,
``read_from_array``, ``shrink_rnn_memory``), so the grad op replays the
index its forward saw, as the reference does
(``paddle_tpu/fluid/executor.py:448-471``).  ``write_to_array`` sees the
array its output already holds (``Out@CURRENT``) and appends to it.
ShareLoD never gives a LoD to a parameter or to the grad of a
persistable: a parameter whose row count equals a batch's packed rows
would otherwise keep that batch's LoD (through its grad and the optimizer
op) and refuse the next batch (a repair of the rule the reference still
has).

No jit, compile cache or verifier in this slice.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import core
from .control_flow_exec import HANDLERS, host_names
from .cuda_graph import StepGraph
from .framework import (RNG_STATE_VAR, OpRole, Parameter, Program,
                        Variable, default_main_program)
from .lod_tensor import LoDTensor, _lengths_to_offsets, _to_numpy
from .selected_rows import SelectedRows
from ..ops import registry as _reg
from ..ops.array_ops import TensorArray
from ..ops.registry import LOD_SUFFIX

_CONST_OPS = frozenset(["assign_value", "fill_constant"])
# ops a run keeps whoever reads their outputs (the reference's
# ``_SIDE_EFFECT_OPS``): they print or write files
_SIDE_EFFECT_OPS = frozenset(["print", "save", "save_combine"])
# ops no step runs (the reference's ``_SKIP_OPS``): ``Executor.run`` pops a
# reader's batch into the feed before the step (``_pop_readers``)
_SKIP_OPS = frozenset(["read", "create_py_reader"])
# ops that read the value an output already holds (``ExecContext.cur_out``):
# an array appended to, the range quantizer's window of scales
_CURRENT_OUTPUTS = {"write_to_array": "Out",
                    "fake_quantize_range_abs_max": "OutScales"}
# ops whose grad op reads a host index the loop may since have moved
_HOST_STASH_OPS = frozenset(["write_to_array", "read_from_array",
                             "shrink_rnn_memory"])
FWD_HOST = "@FWD_HOST@"
# attrs that name an op's own role and vars, not what it computes
_ROLE_ATTRS = frozenset([OpRole.KEY, OpRole.VAR_KEY])


# the value of a var that ``Scope.var`` made and nothing set yet
_UNINIT = object()


class _ScopeTensor:
    """The tensor view of a scope var (the reference's ``_ScopeTensor``):
    ``np.array(t)``, ``t.set(array, place)``, ``t.shape``, the LoD.
    Reading a var that ``Scope.var`` made and nothing set raises."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def _value(self):
        v = self._scope._values[self._name]
        if v is _UNINIT:
            raise ValueError(
                f"Variable '{self._name}' exists in the scope but holds no "
                f"tensor yet (made by Scope.var and never set)")
        return v

    def __array__(self, dtype=None, copy=None):
        a = _to_numpy(self._value())
        return a.astype(dtype) if dtype is not None else a

    def set(self, array, place=None):
        """Write ``array`` into the var: in place where the var holds a
        tensor of its shape and dtype (so a captured graph that holds the
        tensor stays valid), else as a new tensor on ``place``'s device
        (the held tensor's device, or the CPU, when no place is given)."""
        arr = np.asarray(array)
        cur = self._scope._values.get(self._name)
        src = torch.from_numpy(np.array(arr))
        if isinstance(cur, torch.Tensor) and tuple(cur.shape) == arr.shape \
                and cur.dtype == src.dtype and (
                    place is None or cur.device == core.torch_device(place)):
            cur.copy_(src)
            return
        if place is not None:
            device = core.torch_device(place)
        else:
            device = cur.device if isinstance(cur, torch.Tensor) else "cpu"
        self._scope._values[self._name] = src.to(device)

    @property
    def shape(self):
        return tuple(self._value().shape)

    def recursive_sequence_lengths(self):
        from .lod_tensor import _offsets_to_lengths

        return [_offsets_to_lengths(level)
                for level in self._scope._lods.get(self._name) or ()]

    def set_recursive_sequence_lengths(self, lengths):
        self._scope._lods[self._name] = tuple(
            _lengths_to_offsets(n) for n in lengths)

    def lod(self):
        return self._scope._lods.get(self._name) or ()

    def set_lod(self, lod):
        self._scope._lods[self._name] = tuple(
            tuple(int(x) for x in level) for level in lod)


class _ScopeVar:
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return _ScopeTensor(self._scope, self._name)


class Scope:
    """name -> tensor table; ``_lods``: name -> the LoD (offsets form) a
    run left on a persistable."""

    def __init__(self):
        self._values: Dict[str, object] = {}
        self._lods: Dict[str, tuple] = {}

    def var(self, name) -> _ScopeVar:
        """The var ``name``, made (holding no tensor) if the scope has
        none: reading it faults until it is set, so a misspelt name never
        reads zeros."""
        self._values.setdefault(name, _UNINIT)
        return _ScopeVar(self, name)

    def find_var(self, name):
        """The var ``name``, or None."""
        return _ScopeVar(self, name) if name in self._values else None

    def get(self, name, default=None):
        v = self._values.get(name, default)
        return default if v is _UNINIT else v

    def set(self, name, value):
        self._values[name] = value


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    """Make ``scope`` the :func:`global_scope` inside the ``with`` block
    (the reference's ``fluid.scope_guard``)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def _resolve(op_type: str):
    """(op def, is_grad): a ``<type>_grad`` op resolves to its forward
    op's def unless registered on its own; a control-flow op, which a
    handler runs, to (None, False)."""
    if op_type in HANDLERS:
        return None, False
    is_grad = (not _reg.is_registered(op_type) and op_type.endswith("_grad")
               and _reg.is_registered(op_type[:-5]))
    return _reg.get_op_def(op_type[:-5] if is_grad else op_type), is_grad


def _needed_inputs(op, block, opdef, is_grad) -> List[str]:
    """The names ``op`` really reads.  A generic grad op re-runs the
    forward from its inputs, so the forward op's outputs it is handed are
    not read.  ``write_to_array`` reads the array its output holds."""
    if op.type == "write_to_array":
        return [n for n in op.input_arg_names + op.output_arg_names if n]
    if is_grad and opdef.grad_fn is None:
        fwd_idx = op.attr("__fwd_op_idx__")
        fwd = block.ops[fwd_idx] if fwd_idx is not None else None
        skip = set(fwd.outputs) - set(fwd.inputs) if fwd is not None else ()
        return [n for slot, names in op.inputs.items() if slot not in skip
                for n in names if n]
    return [n for n in op.input_arg_names if n]


def _snapshot(v):
    """A fetched value as numpy: a tensor's copy, a host value's copy; a
    SelectedRows (a sparse table grad), as the reference returns it, a 0-d
    object array holding it, here with CPU copies of its rows and values;
    a tensor array, an array of numpy copies."""
    if isinstance(v, SelectedRows):
        out = np.empty((), dtype=object)
        out[()] = v.map(lambda t: t.detach().to("cpu", copy=True))
        return out
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, TensorArray):
        return TensorArray([None if t is None else _snapshot(t)
                            for t in v.vals], list(v.lods))
    return _to_numpy(v)


def _copy(v, device):
    """A fetched value for ``return_numpy=False``: a copy on its device (a
    host value's on ``device``)."""
    if isinstance(v, SelectedRows):
        return v.map(lambda t: t.detach().clone())
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy()).to(device)
    if isinstance(v, TensorArray):
        return TensorArray([None if t is None else _copy(t, device)
                            for t in v.vals], list(v.lods))
    return v.detach().clone()


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def _find_groups(ops, const_ops) -> List[List[int]]:
    """The indices of each maximal run of two or more consecutive ops that
    one group impl runs at once: non-constant ops of one type that has a
    group impl, their attrs equal but for ``op_role`` / ``op_role_var``,
    and no member reading or writing a name another member writes (an op
    that would break this starts a new run)."""
    runs: List[List[int]] = []
    cur: List[int] = []
    reads, writes, attrs = set(), set(), None
    for k, op in enumerate(ops):
        opdef = _reg.REGISTRY.get(op.type)
        if opdef is None or opdef.group_fn is None or id(op) in const_ops:
            if len(cur) > 1:
                runs.append(cur)
            cur = []
            continue
        r = {n for n in op.input_arg_names if n}
        w = {n for n in op.output_arg_names if n}
        a = {key: v for key, v in op.attrs.items() if key not in _ROLE_ATTRS}
        if not (cur and op.type == ops[cur[0]].type and a == attrs
                and not r & writes and not w & (reads | writes)):
            if len(cur) > 1:
                runs.append(cur)
            cur, reads, writes, attrs = [], set(), set(), a
        cur.append(k)
        reads |= r
        writes |= w
    if len(cur) > 1:
        runs.append(cur)
    return runs


def _live_ops(block, fetch_names) -> list:
    """The ops a run needs: those feeding a fetch or writing a
    persistable, and the ops with a side effect (``_SIDE_EFFECT_OPS``), in
    program order; never a reader op (``_SKIP_OPS``)."""
    def _is_persistable(name: str) -> bool:
        return block._has_var_recursive(name) and \
            block._var_recursive(name).persistable

    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        if op.type in _SKIP_OPS:
            continue
        outs = [n for n in op.output_arg_names if n]
        if not (op.type in _SIDE_EFFECT_OPS
                or any(n in needed for n in outs)
                or any(_is_persistable(n) for n in outs)):
            continue
        kept.append(op)
        needed.update(n for n in op.input_arg_names if n)
    return list(reversed(kept))


def op_is_eager(op) -> bool:
    """Whether ``op`` is a data-dependent op (``registry.EAGER_OPS``) or a
    control-flow op whose sub-block holds one (the reference's
    ``_op_is_eager``, ``paddle_tpu/fluid/executor.py:232-243``)."""
    base = op.type[:-5] if op.type.endswith("_grad") else op.type
    if base in _reg.EAGER_OPS:
        return True
    sub = op.attr("sub_block")
    if isinstance(sub, int):
        return any(op_is_eager(b) for b in op.block.program.block(sub).ops)
    return False


def _draws_random(op) -> bool:
    """Whether ``op``, or an op of its sub-block, draws random numbers."""
    d, is_grad = _resolve(op.type)
    if d is not None and d.stateful and not is_grad:
        return True
    sub = op.attr("sub_block")
    if isinstance(sub, int) and not op.type.endswith("_grad"):
        return any(_draws_random(b) for b in op.block.program.block(sub).ops)
    return False


class BlockPlan:
    """Static analysis of a block for one (feeds, fetches) signature: the
    live ops, the names read from the scope (state_in), the persistables
    written back (state_out), the outputs each op must produce and the
    names each op is the last to read."""

    def __init__(self, program: Program, feed_names: Sequence[str],
                 fetch_names: Sequence[str]):
        block = program.global_block()
        self.fetch_names = list(fetch_names)

        def _is_persistable(name: str) -> bool:
            return block._has_var_recursive(name) and \
                block._var_recursive(name).persistable

        self.ops = _live_ops(block, fetch_names)
        resolved = [_resolve(op.type) for op in self.ops]
        self.needs_rng = any(_draws_random(op) for op in self.ops)
        # constant ops whose outputs no one persists: run once, reuse
        self.const_ops = {
            id(op) for op in self.ops
            if op.type in _CONST_OPS
            and not any(_is_persistable(n) for n in op.output_arg_names)}
        self.consts: Dict[str, torch.Tensor] = {}

        written = set(feed_names)
        state_in: List[str] = []
        for op in self.ops:
            for name in op.input_arg_names:
                if name and name not in written and name not in state_in:
                    state_in.append(name)
            written.update(n for n in op.output_arg_names if n)
        for name in self.fetch_names:
            if name not in written and name not in state_in:
                state_in.append(name)
        state_out: List[str] = []
        for op in self.ops:
            for name in op.output_arg_names:
                if name and name not in state_out and (
                        name in state_in or _is_persistable(name)):
                    state_out.append(name)
        self.state_in = state_in
        self.state_out = state_out

        # liveness: the last op that reads each name; outputs read by no
        # later op and not kept are neither asked for nor held
        keep = set(self.fetch_names) | set(state_out)
        reads = [_needed_inputs(op, block, d, g)
                 for op, (d, g) in zip(self.ops, resolved)]
        last_read: Dict[str, int] = {}
        for k, names in enumerate(reads):
            for n in names:
                last_read[n] = k
        self.reads = reads
        self.live_outputs = []
        self.release: List[List[str]] = [[] for _ in self.ops]
        for k, op in enumerate(self.ops):
            live = {}
            for slot, names in op.outputs.items():
                kept_names = [n for n in names if n and (
                    n in keep or last_read.get(n, -1) > k)]
                if kept_names:
                    live[slot] = kept_names
            self.live_outputs.append(live)
        for n, k in last_read.items():
            if n not in keep:
                self.release[k].append(n)
        for k, op in enumerate(self.ops):
            for n in op.output_arg_names:
                if n and n not in keep and last_read.get(n, -1) <= k:
                    self.release[k].append(n)
        # a LoD entry lives to the last op that names its var among its
        # inputs (a generic grad op is handed the forward's outputs' LoDs,
        # as in the reference, though it reads none of their values)
        last_named: Dict[str, int] = {}
        for k, op in enumerate(self.ops):
            for n in op.input_arg_names:
                if n:
                    last_named[n] = k
        for n, k in last_named.items():
            if n not in keep:
                self.release[k].append(n + LOD_SUFFIX)
        for k, op in enumerate(self.ops):
            for n in op.output_arg_names:
                if n and n not in keep and last_named.get(n, -1) <= k:
                    self.release[k].append(n + LOD_SUFFIX)
        # names an op both reads and writes: updated in place when the
        # output is the input tensor itself (the first run checks)
        self.in_place = [sorted(set(op.output_arg_names)
                                & set(op.input_arg_names) - {""})
                         for op in self.ops]
        self.in_place_names = {n for names in self.in_place for n in names}
        # runs executed as one group: first member's index -> members
        self.groups: Dict[int, List[int]] = {
            run[0]: run for run in _find_groups(self.ops, self.const_ops)}
        self.grouped = {k for run in self.groups.values() for k in run[1:]}
        self.checked = False
        # the guarded step's check goes before the first optimizer op
        self.optimize = [op.attr(OpRole.KEY) == OpRole.Optimize
                         for op in self.ops]
        self.first_optimize = next(
            (k for k, o in enumerate(self.optimize) if o), len(self.ops))
        # what a guarded window snapshots before that op: the names the
        # optimizer ops update in place
        self.optimize_in_place = sorted(
            {n for k, names in enumerate(self.in_place) if self.optimize[k]
             for n in names})


def _context(op, env, device, generator, outputs_spec):
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = [env.get(n) if n else None for n in names]
        lods = [env.get(n + LOD_SUFFIX) if n else None for n in names]
        if any(lod is not None for lod in lods):
            inputs[slot + LOD_SUFFIX] = lods
    host = False
    cur_slot = _CURRENT_OUTPUTS.get(op.type)
    if cur_slot is not None:
        inputs[cur_slot + _reg.CURRENT_SUFFIX] = [
            env.get(n) if n else None for n in op.outputs.get(cur_slot, [])]
    elif op.type == "fill_constant":
        hosts = host_names(op.block.program)
        host = all(n in hosts for n in op.output_arg_names if n)
    if op.type in _HOST_STASH_OPS:
        # the host inputs this op saw, for its grad op to replay
        env.setdefault(FWD_HOST, {})[id(op)] = {
            slot: list(vals) for slot, vals in inputs.items()
            if any(isinstance(v, np.ndarray) for v in vals)}
    elif op.type[:-5] in _HOST_STASH_OPS and op.type.endswith("_grad"):
        fwd_idx = op.attr("__fwd_op_idx__")
        if fwd_idx is not None and fwd_idx < len(op.block.ops):
            inputs.update(env.get(FWD_HOST, {}).get(
                id(op.block.ops[fwd_idx]), {}))
    if outputs_spec is None:
        outputs_spec = {slot: list(names)
                        for slot, names in op.outputs.items() if names}
    return _reg.ExecContext(op.type, inputs, outputs_spec, op.attrs, device,
                            generator, host)


def _takes_no_lod(op, name) -> bool:
    """A parameter, or the grad (or a partial grad) of a persistable:
    ShareLoD never gives it a batch's LoD, so no LoD reaches the
    optimizer's state."""
    block = op.block
    base, is_grad = name.split("@GRAD", 1)[0], "@GRAD" in name
    if not block._has_var_recursive(base):
        return False
    var = block._var_recursive(base)
    return var.persistable if is_grad else isinstance(var, Parameter)


def _store(op, env, raw, inputs):
    """Bind ``raw``'s outputs in ``env`` with their LoDs: the one the op
    returned under ``<slot>@LOD`` (a list parallel to the slot's names, or
    one LoD), else the reference's ShareLoD (``paddle_tpu/fluid/
    executor.py:498-525``): the op's inputs' LoD when they carry exactly
    one distinct LoD and the output's leading dim equals its packed row
    count, unless the output is a parameter or the grad of a persistable.
    Rebinding a name drops its old LoD."""
    out_lods = {}
    if raw:
        for k in [k for k in raw if k.endswith(LOD_SUFFIX)]:
            v = raw.pop(k)
            out_lods[k[:-len(LOD_SUFFIX)]] = v if isinstance(v, list) else [v]
    outs = _reg.normalize_outputs(raw)
    in_lods = {tuple(map(tuple, lod)) for k, lods in inputs.items()
               if k.endswith(LOD_SUFFIX) for lod in lods if lod is not None}
    share = next(iter(in_lods)) if len(in_lods) == 1 else None
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        lods = out_lods.get(slot)
        for i, name in enumerate(names):
            if not name:
                continue
            if vals is not None and i < len(vals) and vals[i] is not None:
                env[name] = vals[i]
                env.pop(name + LOD_SUFFIX, None)
                shape = getattr(vals[i], "shape", None)
                if (lods is None or i >= len(lods)) and share is not None \
                        and shape and shape[0] == share[-1][-1] \
                        and not _takes_no_lod(op, name):
                    env[name + LOD_SUFFIX] = share
            if lods is not None and i < len(lods) and lods[i] is not None:
                env[name + LOD_SUFFIX] = tuple(tuple(int(o) for o in level)
                                               for level in lods[i])


def run_op(op, env: Dict[str, object], device, generator=None,
           outputs_spec=None):
    """Execute one IR op eagerly against ``env`` (name -> tensor).
    ``outputs_spec`` (default: every output) names the outputs someone
    reads.  A control-flow op goes to its handler."""
    handler = HANDLERS.get(op.type)
    if handler is not None:
        handler(op, env, device, generator, run_op)
        return
    opdef, is_grad = _resolve(op.type)
    ctx = _context(op, env, device, generator, outputs_spec)
    if not is_grad:
        raw = opdef.fn(ctx)
    elif opdef.grad_fn is not None:
        raw = opdef.grad_fn(ctx)
    else:
        raw = _reg.run_grad_generic(opdef, ctx)
    _store(op, env, raw, ctx.inputs)


def run_group(ops, env: Dict[str, object], device, generator=None,
              outputs_specs=None):
    """Execute a run of ops of one type at once through the type's group
    impl, against ``env``; ``outputs_specs``: each op's ``outputs_spec``
    of :func:`run_op`."""
    specs = outputs_specs or [None] * len(ops)
    ctxs = [_context(op, env, device, generator, spec)
            for op, spec in zip(ops, specs)]
    for op, ctx, raw in zip(ops, ctxs,
                            _reg.get_op_def(ops[0].type).group_fn(ctxs)):
        _store(op, env, raw, ctx.inputs)


def _check_no_alias(reader, names, env, updated):
    """Raise if a name ``reader`` reads is a view of a tensor that an
    earlier op of the run updated in place under another name."""
    for n in names:
        t = env.get(n)
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            continue
        ptr = _storage(t)
        owner = updated.get(ptr) if ptr else None
        if owner is not None and owner != n:
            raise RuntimeError(
                f"{reader} reads {n!r}, a view of {owner!r}, which an "
                f"earlier op of this run updated in place")


def _execute(plan, env, device, generator, fetch_names, guard=None,
             seed_mul=None, device_flag=False, dp=None):
    """Run ``plan``'s ops against ``env``.  Guarded (``guard``): before the
    first ``Optimize`` op, either read the finite flag on the host and skip
    the ``Optimize`` ops on overflow (the loss scaler's host gate), or
    (``device_flag``) snapshot what those ops update in place and run them
    all (the caller commits ``torch.where(ok, new, old)``).  Returns
    ``(finite, snapshot)``: the host flag (None on the device gate, or if
    no ``Optimize`` op came) and the snapshot.  ``dp``: a data-parallel
    step's hooks (``parallel/spmd.py`` ``ShardedTrainStep``): the fsdp
    gathers before an op, each op run under its tp rule
    (``parallel/placement.py``), the group around the ops that cross the
    batch, the grads' sum after the last op that writes one, ZeRO-1's
    optimizer ops on a rank's chunk and the parameters' all-gather after
    them."""
    from . import guardian as _guardian

    updated = None if plan.checked else {}
    finite, snapshot, skip = None, {}, False
    for k, op in enumerate(plan.ops):
        if dp is not None:
            for j in plan.groups.get(k, [k]):
                dp.before(j, env)
        if guard is not None and k == plan.first_optimize:
            if device_flag:
                snapshot = {n: env[n].clone()
                            for n in plan.optimize_in_place
                            if isinstance(env.get(n), torch.Tensor)}
            else:
                finite = _guardian.step_finite(
                    env[guard.loss_name],
                    [env[n] for n in guard.grad_names])
                skip = not finite
        if skip and plan.optimize[k]:
            # overflow: the update is skipped (its group with it)
            for n in plan.release[k]:
                env.pop(n, None)
            continue
        if id(op) in plan.const_ops:
            if op.output_arg_names[0] not in plan.consts:
                run_op(op, env, device, generator)
                for n in op.output_arg_names:
                    plan.consts[n] = env[n]
        elif k not in plan.grouped:
            members = plan.groups.get(k, [k])
            before = {}
            if updated is not None:
                # each member as if the earlier ones had run before it
                seen = dict(updated)
                for j in members:
                    _check_no_alias(plan.ops[j].type, plan.reads[j], env,
                                    seen)
                    for n in plan.in_place[j]:
                        t = env.get(n)
                        if isinstance(t, torch.Tensor):
                            ptr = before[n] = _storage(t)
                            seen[ptr] = n
            if dp is not None and dp.sliced(k):
                dp.run_sliced([plan.ops[j] for j in members], env, device,
                              generator,
                              [plan.live_outputs[j] for j in members],
                              run_op, run_group)
            elif len(members) > 1 and (dp is None or dp.groupable(k)):
                run_group([plan.ops[j] for j in members], env, device,
                          generator, [plan.live_outputs[j] for j in members])
            elif dp is not None:
                for j in members:
                    dp.run_op(j, plan.ops[j], env, device, generator,
                              plan.live_outputs[j], run_op)
            else:
                run_op(op, env, device, generator, plan.live_outputs[k])
            for n, ptr in before.items():
                if ptr and _storage(env[n]) == ptr:
                    updated[ptr] = n
            if seed_mul is not None and "__loss_seed__" in op.attrs:
                for n in op.output_arg_names:
                    env[n] = env[n] * seed_mul.to(env[n].dtype)
        if dp is not None:
            dp.after(k, env)
        for n in plan.release[k]:
            env.pop(n, None)
    if updated is not None:
        _check_no_alias("the fetch list", fetch_names, env, updated)
        plan.checked = True
    return finite, snapshot


def _run_step(plan, env, device, generator, fetch_names, guard=None,
              sentinel=None, gate=None, state=None, dp=None):
    """One step of ``plan`` over ``env``; returns ``(new_state, health)``.
    Unguarded: the persistable outputs, health None.  Guarded: the seed
    multiplied by :func:`~.guardian.seed_multiplier` (``sentinel``: the
    step's ``seed_mul``, ``loss_mul``, ``loss_cap``; ``state``: the scale
    vars), then the commit of :func:`~.guardian.fold_health`: with
    ``gate="device"`` a snapshot of what the ``Optimize`` ops update in
    place and ``torch.where(ok, new, old)`` on the device (health: 0-d
    device tensors); with ``gate="host"`` the loss scaler's host read,
    the ``Optimize`` ops skipped on overflow (health None).  ``dp``: see
    :func:`_execute`."""
    from . import guardian as _guardian

    if guard is None:
        _execute(plan, env, device, generator, fetch_names, dp=dp)
        return {n: env[n] for n in plan.state_out}, None
    start = dict(env)
    seed_mul = _guardian.seed_multiplier(guard, state, sentinel, device)
    finite, snapshot = _execute(plan, env, device, generator, fetch_names,
                                guard, seed_mul,
                                device_flag=gate == "device", dp=dp)
    extra = [env[n] for n in guard.extra_fetch_names()]
    if gate != "device" and finite is None:
        finite = _guardian.step_finite(extra[0], extra[1:])
    return _guardian.fold_health(
        guard, extra, {n: env[n] for n in plan.state_out},
        {n: snapshot.get(n, start[n]) for n in plan.state_out
         if n in start},
        state, sentinel, finite=finite)


def _check_nan_inf(named_vals):
    """Under ``FLAGS_check_nan_inf``: raise naming the first floating value
    that holds a NaN or an Inf (one host read each)."""
    if not core.GLOBAL_FLAGS.get("check_nan_inf"):
        return
    for name, val in named_vals:
        if isinstance(val, SelectedRows):
            val = val.values
        if isinstance(val, TensorArray):
            continue
        if isinstance(val, torch.Tensor):
            bad = val.is_floating_point() and \
                not bool(torch.isfinite(val).all())
        else:
            arr = np.asarray(val)
            bad = np.issubdtype(arr.dtype, np.floating) and \
                not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(
                f"check_nan_inf: variable '{name}' contains NaN/Inf after "
                f"op block execution")


def _prune_for_unfed(program, feeds, fetch_names, scope):
    """A program with a declared data var that is neither fed nor in the
    scope, read by some op (a mixed program whose other branch the caller
    does not fetch), runs pruned to the fetch targets: first keeping the
    ops that write persistables, else without Backward and Optimize ops,
    whichever drops every such var and still yields every fetch.  If none
    does, the program stays as it is and the run raises on the var.  The
    pruned program is cached on the program, per version."""
    if not fetch_names:
        return program
    gb = program.global_block()
    candidates = [v.name for v in gb.vars.values()
                  if getattr(v, "is_data", False) and v.name not in feeds
                  and scope.get(v.name, None) is None]
    if not candidates:
        return program
    consumed = {n for op in gb.ops for n in op.input_arg_names}
    unfed = sorted(n for n in candidates if n in consumed)
    if not unfed:
        return program
    cache_ver, cache = getattr(program, "_unfed_prune_cache", (None, None))
    if cache_ver != program._version:
        cache = {}
        program._unfed_prune_cache = (program._version, cache)
    key = (tuple(fetch_names), tuple(unfed))
    if key not in cache:
        cache[key] = _try_prunes(program, fetch_names, unfed, scope, feeds)
    return cache[key]


def _try_prunes(program, fetch_names, unfed, scope, feeds):
    def _viable(p):
        produced, consumed = set(), set()
        for op in p.global_block().ops:
            produced.update(op.output_arg_names)
            consumed.update(op.input_arg_names)
        if any(n in consumed for n in unfed):
            return False
        return all(f in produced or f in feeds
                   or scope.get(f, None) is not None for f in fetch_names)

    # A: the live-op slice (a training fetch keeps its optimizer)
    a = program.clone()
    gb = a.global_block()
    gb.ops = _live_ops(gb, fetch_names)
    if _viable(a):
        return a
    # B: without backward and optimize ops (a decode fetch sheds the
    # training branch that shares its parameters)
    b = program._prune(fetch_names,
                       drop_roles=(OpRole.Backward, OpRole.Optimize))
    return b if _viable(b) else program


def _pop_readers(program, feed, device):
    """The feed with one batch popped from each ``read`` op's reader into
    its outputs (the reference's host infeed, ``paddle_tpu/fluid/
    executor.py:936-947``); raises ``core.EOFException`` when a reader is
    exhausted.  A batch ``double_buffer`` staged is on ``device`` already
    and goes through ``_coerce_feed`` without another copy."""
    ver, ops = getattr(program, "_read_ops_cache", (None, None))
    if ver != program._version:  # one walk of the ops per program version
        ops = [op for op in program.global_block().ops if op.type == "read"]
        program._read_ops_cache = (program._version, ops)
    if not ops:
        return feed
    from .layers import io as _io

    feed = dict(feed)
    for op in ops:
        state = _io._reader_state(op.inputs["Reader"][0])
        for name, (value, lod) in zip(op.outputs["Out"],
                                      state.next_batch(device)):
            feed[name] = LoDTensor(value, lod) if lod else value
    return feed


def _has_lod(value) -> bool:
    """Whether a feed value offers a non-empty ``lod`` (a method or an
    attribute)."""
    lod = getattr(value, "lod", None)
    return bool(lod() if callable(lod) else lod)


class _Window:
    """One training step of ``plan`` over static buffers, run ``n`` times a
    window by a :class:`~.cuda_graph.StepGraph`: a buffer per state name
    (``state_in``, ``state_out`` and the guard's scale vars), a buffer per
    feed (one step's slice), and the tensors the last step fetched.  The
    scope holds the state buffers between windows.  A guarded step also
    reads static sentinel buffers (``seed_mul``, ``loss_mul``,
    ``loss_cap``, the step's index in the window and the window's length,
    written before each step) and folds its health into the window's
    aggregate buffers (:func:`~.guardian.window_health_update`)."""

    def __init__(self, plan, guard, fetch_names, feed_specs, scope, device,
                 generator, dp=None):
        from . import guardian as _guardian

        self.plan, self.guard, self.device = plan, guard, device
        self.dp = dp
        self.fetch_names = fetch_names
        self.scope = weakref.ref(scope)
        self.generator = generator
        scale_vars = list(guard.scale_vars or ()) if guard is not None \
            else []
        self.read = [n for n in dict.fromkeys(plan.state_in + scale_vars)
                     if n not in feed_specs]
        self.bufs: Dict[str, torch.Tensor] = {}
        self.feed_bufs = {n: torch.empty(shape, dtype=dtype, device=device)
                          for n, (shape, dtype) in feed_specs.items()}
        self.fetched: List[torch.Tensor] = []
        self.sent: Dict[str, torch.Tensor] = {}
        self.agg: Dict[str, torch.Tensor] = {}
        if guard is not None:
            self.sent = {k: torch.ones((), dtype=torch.float32,
                                       device=device)
                         for k in ("seed_mul", "loss_mul", "loss_cap")}
            self.sent["step_i"] = torch.zeros((), dtype=torch.int32,
                                              device=device)
            self.sent["n_steps"] = torch.zeros((), dtype=torch.int32,
                                               device=device)
            self.agg = _guardian.window_health_init(0, device)
        self.graph = StepGraph(self._step, device,
                               [generator] if generator is not None else [])

    def load(self, scope) -> bool:
        """Bring the scope's values into the buffers (a value that is its
        buffer is left alone, one of the buffer's shape and dtype is copied
        in); False when one no longer fits its buffer."""
        for n in dict.fromkeys(self.read + list(self.bufs)):
            v, b = scope.get(n), self.bufs.get(n)
            if v is None:
                if n in self.read:
                    raise RuntimeError(
                        f"var {n!r} is neither fed nor in the scope (run the "
                        f"startup program first?)")
            elif b is None:
                self.bufs[n] = torch.empty(v.shape, dtype=v.dtype,
                                           device=self.device).copy_(v)
            elif v is not b:
                if tuple(v.shape) != tuple(b.shape) or v.dtype != b.dtype:
                    return False
                b.copy_(v)
        return True

    def _step(self):
        from . import guardian as _guardian

        plan, guard, bufs = self.plan, self.guard, self.bufs
        env: Dict[str, object] = {n: bufs[n] for n in plan.state_in
                                  if n in bufs}
        env.update(self.feed_bufs)
        env.update(plan.consts)
        new_state, health = _run_step(plan, env, self.device,
                                      self.generator, self.fetch_names,
                                      guard, self.sent, "device", bufs,
                                      self.dp)
        self._commit(new_state)
        if health is not None:
            agg = _guardian.window_health_update(
                self.agg, health, self.sent["step_i"], self.sent["n_steps"])
            for k, v in agg.items():
                self.agg[k].copy_(v)
        self.fetched = [env[n] if self.dp is None else
                        self.dp.fetch(n, env[n]) for n in self.fetch_names]

    def _commit(self, new_state):
        """Copy each new value into its buffer, unless it is the buffer
        (updated in place).  A value that lies in another buffer is read
        before any copy writes.  The first step makes the buffers of the
        names nothing read before it (write-only state)."""
        owners = {_storage(b) for b in self.bufs.values()}
        pending = []
        for n, v in new_state.items():
            b = self.bufs.get(n)
            if b is None:
                self.bufs[n] = v.detach().clone(
                    memory_format=torch.contiguous_format)
                continue
            if tuple(v.shape) != tuple(b.shape) or v.dtype != b.dtype:
                raise RuntimeError(
                    f"run_steps: {n!r} turns from {b.dtype} "
                    f"{tuple(b.shape)} into {v.dtype} {tuple(v.shape)} in a "
                    f"step; a window keeps every state var's shape and "
                    f"dtype")
            if _storage(v) == _storage(b):
                continue
            pending.append((b, v.clone() if _storage(v) in owners else v))
        for b, v in pending:
            b.copy_(v)

    def _start_window(self, n_steps, sentinel):
        """Before a guarded window's first step: its length, its loss cap
        and a fresh aggregate, written into the static buffers."""
        from . import guardian as _guardian

        self.sent["n_steps"].fill_(n_steps)
        self.sent["loss_cap"].fill_(float(sentinel["loss_cap"]))
        for k, v in _guardian.window_health_init(n_steps,
                                                 self.device).items():
            self.agg[k].copy_(v)

    def run(self, scope, feed_vals, n_steps, feed_per_step, sentinel=None):
        """Run ``n_steps`` steps; ``sentinel`` (guarded): the window's
        ``loss_cap`` and per-step ``seed_mul`` / ``loss_mul`` arrays."""
        if feed_per_step:
            def feed_step(i):
                for k, v in feed_vals.items():
                    self.feed_bufs[k].copy_(v[i])
        else:
            for k, v in feed_vals.items():
                self.feed_bufs[k].copy_(v)
            # a feed that an op updates in place starts each step afresh
            again = [k for k in feed_vals if k in self.plan.in_place_names]

            def feed_step(i):
                for k in again:
                    self.feed_bufs[k].copy_(feed_vals[k])

        if self.guard is not None:
            self._start_window(n_steps, sentinel)

            def before(i):
                feed_step(i)
                self.sent["step_i"].fill_(i)
                self.sent["seed_mul"].fill_(float(sentinel["seed_mul"][i]))
                self.sent["loss_mul"].fill_(float(sentinel["loss_mul"][i]))
        else:
            before = feed_step
        self.graph.run(n_steps, before)
        for n, b in self.bufs.items():
            scope.set(n, b)
        return [_snapshot(t) for t in self.fetched]

    def close(self):
        self.graph.close()
        self.bufs, self.feed_bufs, self.fetched = {}, {}, []
        self.plan.consts.clear()


class Executor:
    """Runs Programs on ``place`` — the card (``CUDAPlace(0)``) unless the
    caller passes another place.  Raises at construction when the place is
    the card and torch sees no CUDA device."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = core.torch_device(self.place)
        self._plans: Dict[tuple, BlockPlan] = {}
        self._windows: Dict[tuple, _Window] = {}

    def close(self):
        """Drop the cached plans and the windows: their graphs, buffers
        and memory pools (the scope keeps the state's last values)."""
        for win in self._windows.values():
            win.close()
        self._windows.clear()
        self._plans.clear()

    def _coerce_feed(self, program, name, value):
        """``(tensor on the place's device, LoD in offsets form or
        None)``: a ``LoDTensor`` or ``(array, recursive lengths)`` feed
        brings its LoD."""
        lod = None
        if isinstance(value, LoDTensor):
            lod = value.lod() or None
            value = value._data
        elif isinstance(value, tuple) and len(value) == 2 \
                and isinstance(value[1], (list, tuple)):
            value, lengths = value
            lod = tuple(_lengths_to_offsets(n) for n in lengths) or None
        gb = program.global_block()
        want = (core.torch_dtype(gb._var_recursive(name).dtype)
                if gb._has_var_recursive(name) else None)
        if isinstance(value, torch.Tensor):
            t = value
        else:
            arr = np.asarray(value)
            if want is not None:
                arr = arr.astype(core.np_dtype(core.convert_dtype(want)),
                                 copy=False)
            # a copy: an op that updates its input in place
            # (kv_cache_update) must never write into the caller's array
            t = torch.tensor(arr)
        if want is not None and t.dtype != want:
            t = t.to(want)
        return t.to(self.device), lod

    def _generator(self, scope, program) -> torch.Generator:
        """The scope's generator for this device, seeded from the program
        the first time the scope needs one (the reference's
        ``PRNGKey(random_seed)`` kept under ``@RNG_STATE@``)."""
        gens = scope.get(RNG_STATE_VAR)
        if gens is None:
            gens = {}
            scope.set(RNG_STATE_VAR, gens)
        key, seed = self._rng_stream(program)
        gen = gens.get(key)
        if gen is None:
            gen = gens[key] = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        return gen

    def _rng_stream(self, program):
        """The key of this executor's generator in the scope and its seed
        (``ParallelExecutor``'s executor gives each rank its own)."""
        return str(self.device), int(program.random_seed or 0)

    def _dp_step(self, program, plan, feed_vals, feed_lods, scope):
        """The data-parallel hooks of a step (``ParallelExecutor``'s
        executor gives a ``parallel/spmd.py`` ``ShardedTrainStep``); None:
        a single-device step."""
        return None

    @staticmethod
    def _step_boundary(n_steps: int = 1) -> int:
        """The training-step boundary of a run (``n_steps`` 1) or a window:
        fires the armed step faults (a kill armed inside a window fires
        before it) and the straggler's delay.  Returns the first step the
        dispatch runs (the index the guardian's sentinel keys on)."""
        from . import fault as _fault

        fired = _fault.current_step()
        if _fault.active() is not None:
            if n_steps == 1:
                fired = _fault.on_step()
            else:
                _fault.advance(n_steps)
            _fault.straggler_delay(n_steps)
        else:
            _fault._step += n_steps  # the guardian's step index flows on
        return fired

    def _dump_context(self, plan, guard, scope, env, feed_vals, feed_lods,
                      fetch_names, generator):
        """What a replay bundle needs of the step (or window) about to run,
        under the ``dump_and_halt`` policy: copies of its feeds and of
        every state tensor it reads (the step updates some in place), the
        scale vars among them, the generator's state and the AMP mode
        (ops cast by it as they run)."""
        from . import amp as _amp

        state = {}
        for n in dict.fromkeys(plan.state_in + list(guard.scale_vars or ())):
            v = env.get(n, scope.get(n))
            if n not in feed_vals and isinstance(v, torch.Tensor):
                state[n] = v.clone()
        return {"feeds": {k: v.clone() for k, v in feed_vals.items()},
                "feed_lods": {k[:-len(LOD_SUFFIX)]: v
                              for k, v in feed_lods.items()},
                "state": state, "fetch_names": list(fetch_names),
                "device": self.device.type,
                "amp": [_amp.compute_dtype(), _amp.keep_low_activations()],
                "rng_state": (generator.get_state() if generator is not None
                              else None)}

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run ``program`` (default: the main program) on ``feed`` and
        return the values of ``fetch_list`` as snapshots: numpy arrays, or
        tensor copies on the place's device with ``return_numpy=False``.
        ``use_program_cache=False`` analyses the block afresh and keeps
        nothing.  ``feed_var_name`` and ``fetch_var_name`` are accepted as
        in the reference, which names no feed or fetch var either.  Each
        ``read`` op first pops its reader's next batch into the feed
        (``core.EOFException`` at the end of the data).  With
        ``return_numpy=False`` a fetch that carries a LoD comes back as a
        ``LoDTensor`` over the copy.

        A training program (built by ``Optimizer.minimize``) passes the
        fault layer's step boundary first (``fluid.fault``); guarded
        (``fluid.guardian``: a guardian armed, or a loss-scaled program)
        it runs the sentinel, and with a guardian armed the commit gate is
        on the device and the step's health goes to the guardian, which
        reads it at the next boundary."""
        from . import fault as _fault
        from . import guardian as _guardian

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list or []]
        feed = _pop_readers(program, feed or {}, self.device)
        feed_vals, feed_lods = {}, {}
        for k, v in feed.items():
            feed_vals[k], lod = self._coerce_feed(program, k, v)
            if lod:
                feed_lods[k + LOD_SUFFIX] = lod
        program = _prune_for_unfed(program, feed_vals, fetch_names, scope)
        guard = _guardian.for_program(program)
        key = (program._cache_token, program._version,
               tuple(sorted(feed_vals)), tuple(fetch_names),
               guard.cache_token() if guard is not None else None)
        plan = self._plans.get(key) if use_program_cache else None
        if plan is None:
            # a guarded step keeps the loss and the raw grads to its check
            extra = guard.extra_fetch_names() if guard is not None else []
            plan = BlockPlan(program, list(feed_vals),
                             list(dict.fromkeys(fetch_names + extra)))
            if use_program_cache:
                self._plans[key] = plan
        for name in plan.in_place_names.intersection(feed_vals):
            t = feed_vals[name]
            if isinstance(feed[name], torch.Tensor) and \
                    _storage(t) == _storage(feed[name]):
                # an op updates this name in place: never the caller's
                feed_vals[name] = t.clone()
        dp = self._dp_step(program, plan, feed_vals, feed_lods, scope)
        env: Dict[str, object] = {}
        for name in plan.state_in:
            val = scope.get(name)
            if val is None:
                raise RuntimeError(
                    f"var {name!r} is neither fed nor in the scope (run the "
                    f"startup program first?)")
            env[name] = val
            if name in scope._lods:
                env[name + LOD_SUFFIX] = scope._lods[name]
        env.update(feed_vals)
        env.update(feed_lods)
        env.update(plan.consts)
        generator = self._generator(scope, program) if plan.needs_rng \
            else None
        step_idx = 0
        if getattr(program, "_params_grads", None) is not None:
            # the training-step boundary: armed step faults fire here
            step_idx = self._step_boundary()
        g = _guardian.current() if guard is not None else None
        if g is not None:
            # one step late: observe the PREVIOUS step's health and apply
            # the policy before this step runs
            g.on_boundary()
        sentinel, ctx = None, None
        if guard is not None:
            seed_mul, loss_mul = _fault.sentinel_injection(step_idx)
            sentinel = {"loss_cap": np.float32(g.loss_cap() if g is not None
                                               else float("inf")),
                        "seed_mul": np.float32(seed_mul),
                        "loss_mul": np.float32(loss_mul)}
        if g is not None and g.config.policy == "dump_and_halt":
            ctx = self._dump_context(plan, guard, scope, env, feed_vals,
                                     feed_lods, fetch_names, generator)
        t0 = time.perf_counter()
        new_state, health = _run_step(
            plan, env, self.device, generator, fetch_names, guard, sentinel,
            "device" if g is not None else "host",
            {n: scope.get(n) for n in (guard.scale_vars or ())}
            if guard is not None else None, dp)
        if _fault.active() is not None:
            new_state = _fault.corrupt_state(new_state)
        for name, val in new_state.items():
            scope.set(name, val)
            lod = env.get(name + LOD_SUFFIX)
            if lod is not None:
                scope._lods[name] = lod
        _check_nan_inf(list(new_state.items())
                       + [(n, env[n]) for n in fetch_names])
        if g is not None:
            ctx = dict(ctx or {}, program=program, sentinel=sentinel,
                       duration_s=time.perf_counter() - t0)
            g.defer(guard, step_idx, _guardian.HealthCopy(health), ctx)
        vals = [env[n] if dp is None else dp.fetch(n, env[n])
                for n in fetch_names]
        if not return_numpy:
            out = []
            for n, v in zip(fetch_names, vals):
                lod = env.get(n + LOD_SUFFIX)
                out.append(_copy(v, self.device) if lod is None
                           else LoDTensor(_copy(v, self.device), lod))
            return out
        return [_snapshot(v) for v in vals]

    def run_steps(self, program, feed, fetch_list, n_steps, scope=None,
                  feed_per_step=False):
        """Run ``n_steps`` training steps of ``program`` as one window and
        return the LAST step's fetches as numpy arrays.

        ``feed_per_step=False``: every step takes the same ``feed``.
        ``feed_per_step=True``: each feed carries a leading ``n_steps`` dim
        and step ``i`` takes slice ``i``.

        The step runs over static buffers (``_Window``), built once per
        (program, version, fetches, one step's feed shapes and dtypes, AMP
        mode, guard): on the card its first step runs eagerly, the next is
        captured as one CUDA graph and every later step replays it
        (``fluid/cuda_graph.py``); on the CPU every step runs eagerly.
        There is no eager loop on the card: a step that cannot be captured
        raises.  A guarded program (a guardian armed, or fp16 loss
        scaling) gates its update on the device (``fluid/guardian.py``),
        bitwise as ``run`` does; the window's fault boundary fires a kill
        armed inside it before it runs, its per-step sentinel inputs are
        written before each step, and its aggregate health goes to the
        guardian, read at the next boundary.  A value ``scope.set``
        between windows is copied into its buffer, or the step is built
        anew if its shape or dtype changed.  Programs with data-dependent
        ops and LoD feeds raise, as in the reference.  As in the reference,
        a window pops no reader: a ``read`` op's outputs are data vars the
        caller feeds, else the window raises."""
        from . import amp as _amp
        from . import fault as _fault
        from . import guardian as _guardian

        program = program or default_main_program()
        scope = scope or global_scope()
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"run_steps: n_steps must be >= 1; got "
                             f"{n_steps}")
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list or []]
        feed_vals = {}
        for k, v in dict(feed or {}).items():
            feed_vals[k], lod = self._coerce_feed(program, k, v)
            if lod or _has_lod(v):
                raise RuntimeError(
                    "run_steps: LoD feeds are not supported in the scanned "
                    "loop; use Executor.run per step")
        program = _prune_for_unfed(program, feed_vals, fetch_names, scope)
        if feed_per_step:
            bad = {k: tuple(v.shape) for k, v in feed_vals.items()
                   if v.dim() == 0 or v.shape[0] != n_steps}
            if bad:
                raise ValueError(f"run_steps: feed_per_step feeds must "
                                 f"lead with n_steps = {n_steps}; got {bad}")
        specs = {k: (tuple(v.shape[1:] if feed_per_step else v.shape),
                     v.dtype) for k, v in feed_vals.items()}
        guard = _guardian.for_program(program)
        key = (program._cache_token, program._version, tuple(fetch_names),
               tuple(sorted((k, shape, str(dt))
                            for k, (shape, dt) in specs.items())),
               _amp.compute_dtype(), _amp.keep_low_activations(),
               guard.cache_token() if guard is not None else None)
        win = self._windows.get(key)
        if win is None:
            extra = guard.extra_fetch_names() if guard is not None else []
            fetches = list(dict.fromkeys(fetch_names + extra))
            if any(op_is_eager(op)
                   for op in _live_ops(program.global_block(), fetches)):
                # data-dependent ops: the reference runs them outside jit,
                # and a window cannot capture them
                raise RuntimeError(
                    "run_steps: program contains data-dependent eager ops; "
                    "use Executor.run per step")
            plan = BlockPlan(program, list(feed_vals), fetches)
        else:
            plan = win.plan
        generator = self._generator(scope, program) if plan.needs_rng \
            else None
        if win is not None and (win.scope() is not scope
                                or win.generator is not generator
                                or not win.load(scope)):
            win.close()  # another scope, or a value that no longer fits
            win = None
        if win is None:
            dp = self._dp_step(program, plan,
                               {k: v[0] if feed_per_step else v
                                for k, v in feed_vals.items()}, {}, scope)
            win = _Window(plan, guard, fetch_names, specs, scope,
                          self.device, generator, dp)
            win.load(scope)
            self._windows[key] = win
        window_start = 0
        if getattr(program, "_params_grads", None) is not None:
            window_start = self._step_boundary(n_steps)
        g = _guardian.current() if guard is not None else None
        if g is not None:
            g.on_boundary()  # the previous dispatch's health, one late
        sentinel, ctx = None, None
        if guard is not None:
            seed_mul, loss_mul = _fault.sentinel_injection_window(
                window_start, n_steps)
            sentinel = {"loss_cap": np.float32(g.loss_cap() if g is not None
                                               else float("inf")),
                        "seed_mul": seed_mul, "loss_mul": loss_mul}
        if g is not None and g.config.policy == "dump_and_halt":
            ctx = self._dump_context(plan, guard, scope, win.bufs, feed_vals,
                                     {}, fetch_names, generator)
        t0 = time.perf_counter()
        fetched = win.run(scope, feed_vals, n_steps, feed_per_step, sentinel)
        if _fault.active() is not None:
            state = {n: scope.get(n) for n in win.plan.state_out}
            for n, v in _fault.corrupt_state(state).items():
                if v is not state[n]:
                    scope.set(n, v)
        _check_nan_inf([(n, scope.get(n)) for n in win.plan.state_out]
                       + list(zip(fetch_names, fetched)))
        if g is not None:
            ctx = dict(ctx or {}, program=program, sentinel=sentinel,
                       duration_s=time.perf_counter() - t0,
                       window={"start": window_start, "n_steps": n_steps,
                               "feed_per_step": bool(feed_per_step)})
            g.defer(guard, window_start, _guardian.HealthCopy(win.agg), ctx)
        return fetched
