"""Scope + Executor (counterpart of ``paddle_tpu/fluid/executor.py``).

The reference traces a whole block into one jitted XLA program.  The port
runs it eagerly, op by op, with PyTorch on the place's device:

 - ``BlockPlan`` keeps the ops a run needs (those feeding a fetch or
   writing a persistable) and finds which names come from the scope;
 - persistable state lives in the :class:`Scope` as device tensors.  Ops
   that update state in place (``kv_cache_update``) mutate the scope's
   tensor directly — the reference gets the same effect from XLA buffer
   donation (``program._donate_state``);
 - constant ops (``assign_value``, ``fill_constant`` of non-persistables)
   run once per plan and their device tensors are reused: no op writes its
   inputs in place except the cache of ``kv_cache_update``, which is always
   persistable;
 - random ops draw from one ``torch.Generator`` per run, on the device,
   seeded from ``Program.random_seed``;
 - fetches come back as numpy arrays.

No jit, windows, guardian, compile cache or verifier in this slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import core
from .framework import Program, Variable, default_main_program
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


class BlockPlan:
    """Static analysis of a block for one (feeds, fetches) signature: the
    live ops, the names read from the scope (state_in) and the persistables
    written back (state_out)."""

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
        self.defs = [_reg.get_op_def(op.type) for op in self.ops]
        self.needs_rng = any(d.stateful for d in self.defs)
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


def run_op(op, env: Dict[str, object], device, generator=None):
    """Execute one IR op eagerly against ``env`` (name -> tensor)."""
    opdef = _reg.get_op_def(op.type)
    inputs = {slot: [env.get(n) if n else None for n in names]
              for slot, names in op.inputs.items()}
    outputs_spec = {slot: list(names) for slot, names in op.outputs.items()
                    if names}
    ctx = _reg.ExecContext(op.type, inputs, outputs_spec, op.attrs, device,
                           generator)
    outs = _reg.normalize_outputs(opdef.fn(ctx))
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        for i, name in enumerate(names):
            if name and vals is not None and i < len(vals) \
                    and vals[i] is not None:
                env[name] = vals[i]


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
        generator = None
        if plan.needs_rng:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(program.random_seed))
        for op in plan.ops:
            if id(op) in plan.const_ops:
                if op.output_arg_names[0] in plan.consts:
                    continue
                run_op(op, env, self.device, generator)
                for n in op.output_arg_names:
                    plan.consts[n] = env[n]
                continue
            run_op(op, env, self.device, generator)
        for name in plan.state_out:
            scope.set(name, env[name])
        return [env[n].detach().cpu().numpy() for n in fetch_names]
