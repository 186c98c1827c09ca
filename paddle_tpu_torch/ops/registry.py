"""Operator registry: op type -> PyTorch implementation (counterpart of
``paddle_tpu/ops/registry.py``).

An op impl is a plain function ``fn(ctx) -> {slot: tensor | [tensors]}``
over the tensors the Executor hands it; it runs eagerly on whatever device
those tensors lie on.

Groups: an op may also register a group impl (:func:`register_group`) that
runs several ops of its type at once; the Executor hands it each run of
consecutive such ops (the optimizer's per-parameter updates), so one
kernel launch can serve them all.

LoD: sequence metadata is host data.  The Executor hands an op the LoD
of each input that has one (offsets form, a tuple of offset tuples) under
``<slot>@LOD``, read through :meth:`ExecContext.in_lod` /
:meth:`ExecContext.seq_offsets`; an op may return ``<slot>@LOD`` beside
an output to set that output's LoD (else the Executor's ShareLoD rule
applies, ``fluid/executor.py``).  No op reads a device tensor to find
offsets.

Host values: loop counters, array indices and loop conditions are numpy
arrays, as in the reference (``paddle_tpu/ops/random_ops.py:32-45``,
``math_ops.py:173-187``), so a ``while`` condition or an array index is
read with no device sync.  A ``fill_constant`` whose every reader takes a
host value makes one (the Executor sets :attr:`ExecContext.host`); the
comparisons, the logical ops and ``increment`` keep host inputs on the
host; ``max_sequence_len``, ``lod_array_length`` and ``is_empty`` always
answer on the host.  :meth:`ExecContext.input` hands any other op a host
value as a tensor on its device (a copy), so an op impl sees tensors
unless it reads :meth:`ExecContext.raw`.

Gradients: ``append_backward`` emits ``<type>_grad`` ops into the Program.
An op that registers a grad impl (:func:`register_grad`) runs it; every
other grad op runs :func:`run_grad_generic`, which re-runs the forward impl
under autograd and takes ``torch.autograd.grad`` of it — the counterpart of
the reference's ``jax.vjp``.  The reference pays nothing for the re-run
(XLA merges it with the forward); eager PyTorch runs every such forward
twice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

GRAD_SUFFIX = "@GRAD"
LOD_SUFFIX = "@LOD"
# the value an output already holds (``write_to_array`` appends to it)
CURRENT_SUFFIX = "@CURRENT"


class ExecContext:
    """What an op impl sees: input tensors by slot, attrs, the output names
    it must produce, the device ops that create tensors put them on, and
    the generator random ops draw from.  ``outputs_spec`` lists only the
    outputs some later op or the caller reads, so an op may skip an output
    that is not listed.  ``host``: every reader of the op's outputs takes a
    host value (``fill_constant`` then makes a numpy array)."""

    __slots__ = ("op_type", "inputs", "outputs_spec", "attrs", "device",
                 "generator", "host")

    def __init__(self, op_type, inputs, outputs_spec, attrs, device,
                 generator=None, host=False):
        self.op_type = op_type
        self.inputs: Dict[str, List[Any]] = inputs
        self.outputs_spec: Dict[str, List[str]] = outputs_spec
        self.attrs: Dict[str, Any] = attrs
        self.device = device
        self.generator = generator
        self.host = host

    def _tensor(self, v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v)).to(self.device)
        return v

    def input(self, slot: str, idx: int = 0):
        """The idx-th input of a slot; a host value as a tensor on the
        op's device."""
        return self._tensor(self.raw(slot, idx))

    def raw(self, slot: str, idx: int = 0):
        """The idx-th input of a slot as the Executor holds it: a host
        (numpy) value stays one."""
        vals = self.inputs.get(slot) or []
        return vals[idx] if idx < len(vals) else None

    def cur_out(self, slot: str, idx: int = 0):
        """The value the idx-th output of a slot holds before the op runs
        (None if it holds none)."""
        return self.raw(slot + CURRENT_SUFFIX, idx)

    def inputs_list(self, slot: str):
        return [self._tensor(v) for v in self.inputs.get(slot) or []]

    def has_input(self, slot: str) -> bool:
        return bool(self.inputs.get(slot))

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def in_lod(self, slot: str, idx: int = 0):
        """The LoD (tuple of offset tuples) of the idx-th input of a slot,
        or None."""
        vals = self.inputs.get(slot + LOD_SUFFIX) or []
        return vals[idx] if idx < len(vals) else None

    def seq_offsets(self, slot: str, idx: int = 0, level: int = -1):
        """The finest (or given) level of an input's LoD, as a tuple."""
        lod = self.in_lod(slot, idx)
        if not lod:
            raise ValueError(
                f"op {self.op_type}: input slot {slot} carries no LoD "
                f"(feed it as a LoDTensor / set recursive_sequence_lengths)")
        return lod[level]

    def n_outputs(self, slot: str) -> int:
        """How many outputs of ``slot`` someone reads."""
        return len(self.outputs_spec.get(slot) or [])


class OpDef:
    """``stateful``: the op draws random numbers (the executor hands it the
    scope's generator).  ``no_grad_inputs``: input slots that never get a
    gradient.  ``grad_fn``: an explicit grad impl (else the generic one).
    ``group_fn``: runs several ops of this type at once (else None)."""

    __slots__ = ("type", "fn", "grad_fn", "group_fn", "no_grad_inputs",
                 "stateful")

    def __init__(self, type, fn, no_grad_inputs=(), stateful=False):
        self.type = type
        self.fn = fn
        self.grad_fn = None
        self.group_fn = None
        self.no_grad_inputs = frozenset(no_grad_inputs)
        self.stateful = stateful


REGISTRY: Dict[str, OpDef] = {}

# data-dependent op types (output sizes or host effects that depend on the
# values; the reference's ``ops/array_ops.py`` EAGER_OPS): a program that
# holds one, in any block, cannot run as a captured window
# (``Executor.run_steps``).  Of them the port has ``sequence_erase``,
# ``sub_nested_seq``, ``split_lod_tensor``, ``merge_lod_tensor``,
# ``is_empty``, the beam ops, the host metric ops ``chunk_eval``,
# ``ctc_align`` and ``edit_distance``, and the detection host ops
# ``multiclass_nms``, ``generate_proposals``, ``rpn_target_assign``,
# ``generate_proposal_labels`` and ``detection_map``.
EAGER_OPS = frozenset([
    "split_lod_tensor", "merge_lod_tensor", "beam_search",
    "beam_search_decode", "beam_search_pack", "is_empty", "multiclass_nms",
    "sequence_erase", "sub_nested_seq", "save", "load", "save_combine",
    "load_combine", "delete_var", "generate_proposals", "rpn_target_assign",
    "generate_proposal_labels", "detection_map", "chunk_eval", "ctc_align",
    "edit_distance",
])


def register_op(op_type: str, *, no_grad_inputs: Sequence[str] = (),
                stateful: bool = False) -> Callable:
    """Decorator: register ``fn(ctx) -> {slot: tensor | [tensors]}``."""

    def deco(fn):
        if op_type in REGISTRY:
            raise ValueError(f"op {op_type} registered twice")
        REGISTRY[op_type] = OpDef(op_type, fn, no_grad_inputs=no_grad_inputs,
                                  stateful=stateful)
        return fn

    return deco


def register_grad(op_type: str) -> Callable:
    """Decorator: attach an explicit grad impl to a registered op.  It sees
    the forward inputs and outputs under their slot names and the output
    grads under ``<slot>@GRAD``, and returns ``{"<slot>@GRAD": tensor}``
    for each input slot it differentiates."""

    def deco(fn):
        REGISTRY[op_type].grad_fn = fn
        return fn

    return deco


def register_group(op_type: str) -> Callable:
    """Decorator: attach a group impl to a registered op,
    ``fn([ctx, ...]) -> [{slot: tensor | [tensors]}, ...]``: the outputs of
    several ops of this type, each with its own context, computed at once.
    The Executor hands it each run of consecutive ops of the type whose
    attrs are equal (but for the op role) and none of which reads a name
    another writes; the result must equal running ``fn`` on each context in
    turn."""

    def deco(fn):
        REGISTRY[op_type].group_fn = fn
        return fn

    return deco


def get_op_def(op_type: str) -> OpDef:
    try:
        return REGISTRY[op_type]
    except KeyError:
        raise NotImplementedError(
            f"op '{op_type}' has no PyTorch implementation in the port "
            f"yet") from None


def is_registered(op_type: str) -> bool:
    return op_type in REGISTRY


def normalize_outputs(outs) -> Dict[str, List[Any]]:
    norm = {}
    if outs is None:
        return norm
    for slot, v in outs.items():
        norm[slot] = list(v) if isinstance(v, (list, tuple)) else [v]
    return norm


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def run_grad_generic(fwd_def: OpDef, ctx: ExecContext) -> Dict[str, Any]:
    """Execute ``<type>_grad`` with ``torch.autograd.grad`` over the forward
    impl (the reference's ``jax.vjp``, ``paddle_tpu/ops/registry.py:200``).

    ``ctx.inputs`` holds the forward input and output slots and the
    ``<out_slot>@GRAD`` slots; ``ctx.outputs_spec`` names the wanted
    ``<in_slot>@GRAD`` outputs.  The differentiable float inputs are
    detached and made leaves; integer inputs and ``no_grad_inputs`` stay
    as they are; with no input to differentiate, the forward is not re-run.
    ``<slot>@LOD`` companions of the forward's inputs pass
    through to the forward impl; those of the grads (``Out@GRAD@LOD``)
    are dropped, and neither is ever a grad or a leaf.  A forward output
    whose grad is missing gets a zero cotangent, as in the reference."""
    if fwd_def.stateful and fwd_def.grad_fn is None:
        raise NotImplementedError(
            f"stateful op {fwd_def.type} requires an explicit grad impl")
    want = []
    for out_slot in ctx.outputs_spec:
        if not out_slot.endswith(GRAD_SUFFIX):
            raise ValueError(f"bad grad output slot {out_slot}")
        slot = out_slot[:-len(GRAD_SUFFIX)]
        if slot not in fwd_def.no_grad_inputs:
            want.append(slot)
    if not want:
        # no input takes a grad: nothing to re-run the forward for (a host
        # op's forward, such as ``generate_proposals``' NMS, is costly)
        return {}
    out_grads = {slot[:-len(GRAD_SUFFIX)]: vals
                 for slot, vals in ctx.inputs.items()
                 if slot.endswith(GRAD_SUFFIX)
                 and any(v is not None for v in vals)}

    inputs, leaves = {}, []
    for slot, vals in ctx.inputs.items():
        if slot.endswith(GRAD_SUFFIX) or \
                slot.endswith(GRAD_SUFFIX + LOD_SUFFIX):
            continue
        if slot.endswith(LOD_SUFFIX):
            inputs[slot] = vals
            continue
        if slot in want:
            vals = [v.detach().requires_grad_() if _is_float(v) else v
                    for v in vals]
            leaves += [(slot, i, v) for i, v in enumerate(vals)
                       if _is_float(v)]
        inputs[slot] = vals
    fctx = ExecContext(fwd_def.type, inputs, {}, ctx.attrs, ctx.device)
    from ..fluid import amp

    # the backward's bf16/fp16 products sum in fp32, as the forward's
    with amp.fp32_sums():
        with torch.enable_grad():
            outs = normalize_outputs(fwd_def.fn(fctx))
        primals, cots = [], []
        for slot in sorted(out_grads):
            floats = [v for v in outs.get(slot) or [] if _is_float(v)]
            gs = out_grads[slot]
            for i, p in enumerate(floats):
                if not p.requires_grad:
                    continue
                g = gs[i] if i < len(gs) else None
                primals.append(p)
                # the cotangent in the output's runtime dtype (the
                # reference's ``jnp.asarray(g, p.dtype)``): under AMP a
                # bf16 activation read by two ops may sum grads of two
                # dtypes, and autograd refuses a mismatched grad_output
                cots.append(torch.zeros_like(p) if g is None
                            else g.to(p.dtype))
        grads = [None] * len(leaves)
        if primals and leaves:
            grads = torch.autograd.grad(primals, [t for _, _, t in leaves],
                                        cots, allow_unused=True)
    result: Dict[str, List[Any]] = {
        slot + GRAD_SUFFIX: [None] * len(inputs[slot]) for slot in want}
    for (slot, i, t), g in zip(leaves, grads):
        result[slot + GRAD_SUFFIX][i] = torch.zeros_like(t) if g is None \
            else g
    return result
