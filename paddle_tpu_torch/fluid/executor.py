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

 - a program built with ``fluid.amp`` dynamic loss scaling runs guarded
   (``fluid/guardian.py``): the backward seed is multiplied by the loss
   scale; before the first ``Optimize``-role op one host read checks that
   the loss and every raw grad are finite; on overflow the ``Optimize``
   ops are skipped and every read-write persistable keeps the value the
   step started from (the ops before them only rebind names), and the
   scale vars are updated either way.

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

As in the reference: a ``LoDTensor`` (or ``(array, lengths)``) feeds its
data (no op of the port reads a LoD yet, so the LoD goes no further); a
program whose declared data var is neither fed nor in the scope is pruned
to the fetch targets when that drops the var (``_prune_for_unfed``); and
with ``core.GLOBAL_FLAGS["check_nan_inf"]`` every run reads its new state
and fetches on the host and raises ``FloatingPointError`` naming the first
that is not finite (a sync a run: for debugging).

No jit, compile cache or verifier in this slice, and of the guardian only
the loss scaler's part.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import core
from .cuda_graph import StepGraph
from .framework import (RNG_STATE_VAR, OpRole, Program, Variable,
                        default_main_program)
from .lod_tensor import LoDTensor
from .lod_tensor import _to_numpy
from .selected_rows import SelectedRows
from ..ops import registry as _reg

_CONST_OPS = frozenset(["assign_value", "fill_constant"])
# attrs that name an op's own role and vars, not what it computes
_ROLE_ATTRS = frozenset([OpRole.KEY, OpRole.VAR_KEY])


class Scope:
    """name -> tensor table."""

    def __init__(self):
        self._values: Dict[str, object] = {}

    def get(self, name, default=None):
        return self._values.get(name, default)

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
    op's def unless registered on its own."""
    is_grad = (not _reg.is_registered(op_type) and op_type.endswith("_grad")
               and _reg.is_registered(op_type[:-5]))
    return _reg.get_op_def(op_type[:-5] if is_grad else op_type), is_grad


def _needed_inputs(op, block, opdef, is_grad) -> List[str]:
    """The names ``op`` really reads.  A generic grad op re-runs the
    forward from its inputs, so the forward op's outputs it is handed are
    not read."""
    if is_grad and opdef.grad_fn is None:
        fwd_idx = op.attr("__fwd_op_idx__")
        fwd = block.ops[fwd_idx] if fwd_idx is not None else None
        skip = set(fwd.outputs) - set(fwd.inputs) if fwd is not None else ()
        return [n for slot, names in op.inputs.items() if slot not in skip
                for n in names if n]
    return [n for n in op.input_arg_names if n]


def _snapshot(v):
    """A fetched value as numpy: a tensor's copy; a SelectedRows (a sparse
    table grad), as the reference returns it, a 0-d object array holding
    it, here with CPU copies of its rows and values."""
    if isinstance(v, SelectedRows):
        out = np.empty((), dtype=object)
        out[()] = v.map(lambda t: t.detach().to("cpu", copy=True))
        return out
    return _to_numpy(v)


def _copy(v):
    """A fetched value for ``return_numpy=False``: a copy on its device."""
    if isinstance(v, SelectedRows):
        return v.map(lambda t: t.detach().clone())
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
    persistable, in program order."""
    def _is_persistable(name: str) -> bool:
        return block._has_var_recursive(name) and \
            block._var_recursive(name).persistable

    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        outs = [n for n in op.output_arg_names if n]
        if not (any(n in needed for n in outs)
                or any(_is_persistable(n) for n in outs)):
            continue
        kept.append(op)
        needed.update(n for n in op.input_arg_names if n)
    return list(reversed(kept))


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
        self.needs_rng = any(d.stateful and not g for d, g in resolved)
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
    inputs = {slot: [env.get(n) if n else None for n in names]
              for slot, names in op.inputs.items()}
    if outputs_spec is None:
        outputs_spec = {slot: list(names)
                        for slot, names in op.outputs.items() if names}
    return _reg.ExecContext(op.type, inputs, outputs_spec, op.attrs, device,
                            generator)


def _store(op, env, raw):
    outs = _reg.normalize_outputs(raw)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        for i, name in enumerate(names):
            if name and vals is not None and i < len(vals) \
                    and vals[i] is not None:
                env[name] = vals[i]


def run_op(op, env: Dict[str, object], device, generator=None,
           outputs_spec=None):
    """Execute one IR op eagerly against ``env`` (name -> tensor).
    ``outputs_spec`` (default: every output) names the outputs someone
    reads."""
    opdef, is_grad = _resolve(op.type)
    ctx = _context(op, env, device, generator, outputs_spec)
    if not is_grad:
        raw = opdef.fn(ctx)
    elif opdef.grad_fn is not None:
        raw = opdef.grad_fn(ctx)
    else:
        raw = _reg.run_grad_generic(opdef, ctx)
    _store(op, env, raw)


def run_group(ops, env: Dict[str, object], device, generator=None,
              outputs_specs=None):
    """Execute a run of ops of one type at once through the type's group
    impl, against ``env``; ``outputs_specs``: each op's ``outputs_spec``
    of :func:`run_op`."""
    specs = outputs_specs or [None] * len(ops)
    ctxs = [_context(op, env, device, generator, spec)
            for op, spec in zip(ops, specs)]
    for op, raw in zip(ops, _reg.get_op_def(ops[0].type).group_fn(ctxs)):
        _store(op, env, raw)


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
             seed_mul=None, device_flag=False):
    """Run ``plan``'s ops against ``env``.  Guarded (``guard``): before the
    first ``Optimize`` op, either read the finite flag on the host and skip
    the ``Optimize`` ops on overflow, or (``device_flag``) take the flag as
    a device tensor, snapshot what those ops update in place and run them
    all.  Returns ``(finite, snapshot)``: the flag (None if no
    ``Optimize`` op came: the caller takes it at the end) and the
    snapshot."""
    from . import guardian as _guardian

    updated = None if plan.checked else {}
    finite, snapshot, skip = None, {}, False
    for k, op in enumerate(plan.ops):
        if guard is not None and k == plan.first_optimize:
            loss = env[guard.loss_name]
            grads = [env[n] for n in guard.grad_names]
            if device_flag:
                finite = _guardian.finite_flag(loss, grads)
                snapshot = {n: env[n].clone()
                            for n in plan.optimize_in_place
                            if isinstance(env.get(n), torch.Tensor)}
            else:
                finite = _guardian.step_finite(loss, grads)
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
            if len(members) > 1:
                run_group([plan.ops[j] for j in members], env, device,
                          generator, [plan.live_outputs[j] for j in members])
            else:
                run_op(op, env, device, generator, plan.live_outputs[k])
            for n, ptr in before.items():
                if ptr and _storage(env[n]) == ptr:
                    updated[ptr] = n
            if seed_mul is not None and "__loss_seed__" in op.attrs:
                for n in op.output_arg_names:
                    env[n] = env[n] * seed_mul.to(env[n].dtype)
        for n in plan.release[k]:
            env.pop(n, None)
    if updated is not None:
        _check_no_alias("the fetch list", fetch_names, env, updated)
        plan.checked = True
    return finite, snapshot


def _check_nan_inf(named_vals):
    """Under ``FLAGS_check_nan_inf``: raise naming the first floating value
    that holds a NaN or an Inf (one host read each)."""
    if not core.GLOBAL_FLAGS.get("check_nan_inf"):
        return
    for name, val in named_vals:
        if isinstance(val, SelectedRows):
            val = val.values
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


def _has_lod(value) -> bool:
    lod = getattr(value, "lod", None)
    return bool(lod() if callable(lod) else lod)


class _Window:
    """One training step of ``plan`` over static buffers, run ``n`` times a
    window by a :class:`~.cuda_graph.StepGraph`: a buffer per state name
    (``state_in``, ``state_out`` and the guard's scale vars), a buffer per
    feed (one step's slice), and the tensors the last step fetched.  The
    scope holds the state buffers between windows."""

    def __init__(self, plan, guard, fetch_names, feed_specs, scope, device,
                 generator):
        self.plan, self.guard, self.device = plan, guard, device
        self.fetch_names = fetch_names
        self.scope = weakref.ref(scope)
        self.generator = generator
        scale_vars = list(guard.scale_vars) if guard is not None else []
        self.read = [n for n in dict.fromkeys(plan.state_in + scale_vars)
                     if n not in feed_specs]
        self.bufs: Dict[str, torch.Tensor] = {}
        self.feed_bufs = {n: torch.empty(shape, dtype=dtype, device=device)
                          for n, (shape, dtype) in feed_specs.items()}
        self.fetched: List[torch.Tensor] = []
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
        start = dict(env)
        seed_mul = (_guardian.seed_multiplier(guard, bufs)
                    if guard is not None else None)
        finite, snapshot = _execute(plan, env, self.device, self.generator,
                                    self.fetch_names, guard, seed_mul,
                                    device_flag=True)
        new_state = {n: env[n] for n in plan.state_out}
        if guard is not None:
            if finite is None:
                finite = _guardian.finite_flag(
                    env[guard.loss_name], [env[n] for n in guard.grad_names])
            new_state = _guardian.fold_health(
                guard, finite, new_state,
                {n: snapshot.get(n, start[n]) for n in plan.state_out
                 if n in start}, bufs)
        self._commit(new_state)
        self.fetched = [env[n] for n in self.fetch_names]

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

    def run(self, scope, feed_vals, n_steps, feed_per_step):
        if feed_per_step:
            def before(i):
                for k, v in feed_vals.items():
                    self.feed_bufs[k].copy_(v[i])
        else:
            for k, v in feed_vals.items():
                self.feed_bufs[k].copy_(v)
            # a feed that an op updates in place starts each step afresh
            again = [k for k in feed_vals if k in self.plan.in_place_names]

            def before(i):
                for k in again:
                    self.feed_bufs[k].copy_(feed_vals[k])
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

    def _coerce_feed(self, program, name, value) -> torch.Tensor:
        if isinstance(value, LoDTensor):
            value = value._data
        elif isinstance(value, tuple) and len(value) == 2 \
                and isinstance(value[1], (list, tuple)):
            value = value[0]  # the (array, recursive lengths) form
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
        return t.to(self.device)

    def _generator(self, scope, program) -> torch.Generator:
        """The scope's generator for this device, seeded from the program
        the first time the scope needs one (the reference's
        ``PRNGKey(random_seed)`` kept under ``@RNG_STATE@``)."""
        gens = scope.get(RNG_STATE_VAR)
        if gens is None:
            gens = {}
            scope.set(RNG_STATE_VAR, gens)
        key = str(self.device)
        gen = gens.get(key)
        if gen is None:
            gen = gens[key] = torch.Generator(device=self.device)
            gen.manual_seed(int(program.random_seed or 0))
        return gen

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run ``program`` (default: the main program) on ``feed`` and
        return the values of ``fetch_list`` as snapshots: numpy arrays, or
        tensor copies on the place's device with ``return_numpy=False``.
        ``use_program_cache=False`` analyses the block afresh and keeps
        nothing.  ``feed_var_name`` and ``fetch_var_name`` are accepted as
        in the reference, which names no feed or fetch var either."""
        from . import guardian as _guardian

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list or []]
        feed = feed or {}
        feed_vals = {k: self._coerce_feed(program, k, v)
                     for k, v in feed.items()}
        program = _prune_for_unfed(program, feed_vals, fetch_names, scope)
        guard = _guardian.for_program(program)
        key = (program._cache_token, program._version,
               tuple(sorted(feed_vals)), tuple(fetch_names))
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
        env: Dict[str, object] = {}
        for name in plan.state_in:
            val = scope.get(name)
            if val is None:
                raise RuntimeError(
                    f"var {name!r} is neither fed nor in the scope (run the "
                    f"startup program first?)")
            env[name] = val
        env.update(feed_vals)
        env.update(plan.consts)
        generator = self._generator(scope, program) if plan.needs_rng \
            else None
        started, seed_mul = None, None
        if guard is not None:
            started = dict(env)
            seed_mul = _guardian.seed_multiplier(
                guard, {n: scope.get(n) for n in guard.scale_vars})
        finite, _ = _execute(plan, env, self.device, generator, fetch_names,
                             guard, seed_mul)
        new_state = {name: env[name] for name in plan.state_out}
        if guard is not None:
            if finite is None:
                finite = _guardian.step_finite(
                    env[guard.loss_name], [env[n] for n in guard.grad_names])
            scale_state = {n: scope.get(n) for n in guard.scale_vars}
            new_state = _guardian.fold_health(
                guard, finite, new_state,
                {n: started[n] for n in plan.state_out if n in started},
                scale_state)
        for name, val in new_state.items():
            scope.set(name, val)
        _check_nan_inf(list(new_state.items())
                       + [(n, env[n]) for n in fetch_names])
        if not return_numpy:
            return [_copy(env[n]) for n in fetch_names]
        return [_snapshot(env[n]) for n in fetch_names]

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
        raises.  A guarded (fp16 loss-scaled) program gates its update on
        the device (``fluid/guardian.py``), bitwise as ``run`` does.  A
        value ``scope.set`` between windows is copied into its buffer, or
        the step is built anew if its shape or dtype changed.  Programs
        with data-dependent ops and LoD feeds raise, as in the
        reference."""
        from . import amp as _amp
        from . import guardian as _guardian

        program = program or default_main_program()
        scope = scope or global_scope()
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"run_steps: n_steps must be >= 1; got "
                             f"{n_steps}")
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list or []]
        feed = dict(feed or {})
        if any(_has_lod(v) for v in feed.values()):
            raise RuntimeError("run_steps: LoD feeds are not supported in "
                               "the scanned loop; use Executor.run per step")
        feed_vals = {k: self._coerce_feed(program, k, v)
                     for k, v in feed.items()}
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
               guard is not None)
        win = self._windows.get(key)
        if win is None:
            extra = guard.extra_fetch_names() if guard is not None else []
            fetches = list(dict.fromkeys(fetch_names + extra))
            if any((op.type[:-5] if op.type.endswith("_grad") else op.type)
                   in _reg.EAGER_OPS
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
            win = _Window(plan, guard, fetch_names, specs, scope,
                          self.device, generator)
            win.load(scope)
            self._windows[key] = win
        fetched = win.run(scope, feed_vals, n_steps, feed_per_step)
        _check_nan_inf([(n, scope.get(n)) for n in win.plan.state_out]
                       + list(zip(fetch_names, fetched)))
        return fetched
