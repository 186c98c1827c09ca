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
 - random ops draw from one ``torch.Generator`` per (scope, device), kept
   in the scope under ``@RNG_STATE@`` and seeded from the
   ``Program.random_seed`` of the first run that needs it; later runs,
   startup and main alike, advance it, as the reference's threaded key;
 - fetches come back as numpy arrays.

No jit, windows, guardian, compile cache or verifier in this slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import core
from .framework import RNG_STATE_VAR, Program, Variable, default_main_program
from ..ops import registry as _reg

_CONST_OPS = frozenset(["assign_value", "fill_constant"])


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


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


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

        needed = set(fetch_names)
        kept = []
        for op in reversed(block.ops):
            outs = [n for n in op.output_arg_names if n]
            if not (any(n in needed for n in outs)
                    or any(_is_persistable(n) for n in outs)):
                continue
            kept.append(op)
            needed.update(n for n in op.input_arg_names if n)
        self.ops = list(reversed(kept))
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
        self.checked = False


def run_op(op, env: Dict[str, object], device, generator=None,
           outputs_spec=None):
    """Execute one IR op eagerly against ``env`` (name -> tensor).
    ``outputs_spec`` (default: every output) names the outputs someone
    reads."""
    opdef, is_grad = _resolve(op.type)
    inputs = {slot: [env.get(n) if n else None for n in names]
              for slot, names in op.inputs.items()}
    if outputs_spec is None:
        outputs_spec = {slot: list(names)
                        for slot, names in op.outputs.items() if names}
    ctx = _reg.ExecContext(op.type, inputs, outputs_spec, op.attrs, device,
                           generator)
    if not is_grad:
        raw = opdef.fn(ctx)
    elif opdef.grad_fn is not None:
        raw = opdef.grad_fn(ctx)
    else:
        raw = _reg.run_grad_generic(opdef, ctx)
    outs = _reg.normalize_outputs(raw)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        for i, name in enumerate(names):
            if name and vals is not None and i < len(vals) \
                    and vals[i] is not None:
                env[name] = vals[i]


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


class Executor:
    """Runs Programs on ``place`` — the card (``CUDAPlace(0)``) unless the
    caller passes another place.  Raises at construction when the place is
    the card and torch sees no CUDA device."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = core.torch_device(self.place)
        self._plans: Dict[tuple, BlockPlan] = {}

    def _coerce_feed(self, program, name, value) -> torch.Tensor:
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

    def run(self, program=None, feed=None, fetch_list=None, scope=None):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list or []]
        feed_vals = {k: self._coerce_feed(program, k, v)
                     for k, v in (feed or {}).items()}
        key = (program._cache_token, program._version,
               tuple(sorted(feed_vals)), tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = BlockPlan(program, list(feed_vals),
                                                fetch_names)
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
        updated = None if plan.checked else {}
        for k, op in enumerate(plan.ops):
            if id(op) in plan.const_ops:
                if op.output_arg_names[0] not in plan.consts:
                    run_op(op, env, self.device, generator)
                    for n in op.output_arg_names:
                        plan.consts[n] = env[n]
            else:
                before = {}
                if updated is not None:
                    _check_no_alias(op.type, plan.reads[k], env, updated)
                    before = {n: _storage(env[n]) for n in plan.in_place[k]
                              if isinstance(env.get(n), torch.Tensor)}
                run_op(op, env, self.device, generator,
                       plan.live_outputs[k])
                for n, ptr in before.items():
                    if ptr and _storage(env[n]) == ptr:
                        updated[ptr] = n
            for n in plan.release[k]:
                env.pop(n, None)
        if updated is not None:
            _check_no_alias("the fetch list", fetch_names, env, updated)
            plan.checked = True
        for name in plan.state_out:
            scope.set(name, env[name])
        return [env[n].detach().cpu().numpy() for n in fetch_names]
