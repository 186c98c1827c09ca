"""Operator registry: op type -> PyTorch implementation (counterpart of
``paddle_tpu/ops/registry.py``).

An op impl is a plain function ``fn(ctx) -> {slot: tensor | [tensors]}``
over the tensors the Executor hands it; it runs eagerly on whatever device
those tensors lie on.

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

import torch

GRAD_SUFFIX = "@GRAD"


class ExecContext:
    """What an op impl sees: input tensors by slot, attrs, the output names
    it must produce, the device ops that create tensors put them on, and
    the generator random ops draw from.  ``outputs_spec`` lists only the
    outputs some later op or the caller reads, so an op may skip an output
    that is not listed."""

    __slots__ = ("op_type", "inputs", "outputs_spec", "attrs", "device",
                 "generator")

    def __init__(self, op_type, inputs, outputs_spec, attrs, device,
                 generator=None):
        self.op_type = op_type
        self.inputs: Dict[str, List[Any]] = inputs
        self.outputs_spec: Dict[str, List[str]] = outputs_spec
        self.attrs: Dict[str, Any] = attrs
        self.device = device
        self.generator = generator

    def input(self, slot: str, idx: int = 0):
        vals = self.inputs.get(slot) or []
        return vals[idx] if idx < len(vals) else None

    def inputs_list(self, slot: str):
        return self.inputs.get(slot) or []

    def has_input(self, slot: str) -> bool:
        return bool(self.inputs.get(slot))

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)


class OpDef:
    """``stateful``: the op draws random numbers (the executor hands it the
    scope's generator).  ``no_grad_inputs``: input slots that never get a
    gradient.  ``grad_fn``: an explicit grad impl (else the generic one)."""

    __slots__ = ("type", "fn", "grad_fn", "no_grad_inputs", "stateful")

    def __init__(self, type, fn, no_grad_inputs=(), stateful=False):
        self.type = type
        self.fn = fn
        self.grad_fn = None
        self.no_grad_inputs = frozenset(no_grad_inputs)
        self.stateful = stateful


REGISTRY: Dict[str, OpDef] = {}


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
    as they are.  A forward output whose grad is missing gets a zero
    cotangent, as in the reference."""
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
    out_grads = {slot[:-len(GRAD_SUFFIX)]: vals
                 for slot, vals in ctx.inputs.items()
                 if slot.endswith(GRAD_SUFFIX)
                 and any(v is not None for v in vals)}

    inputs, leaves = {}, []
    for slot, vals in ctx.inputs.items():
        if slot.endswith(GRAD_SUFFIX):
            continue
        if slot in want:
            vals = [v.detach().requires_grad_() if _is_float(v) else v
                    for v in vals]
            leaves += [(slot, i, v) for i, v in enumerate(vals)
                       if _is_float(v)]
        inputs[slot] = vals
    fctx = ExecContext(fwd_def.type, inputs, {}, ctx.attrs, ctx.device)
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
            cots.append(torch.zeros_like(p) if g is None else g.to(p.dtype))
    grads = [None] * len(leaves)
    if primals and leaves:
        grads = torch.autograd.grad(primals, [t for _, _, t in leaves], cots,
                                    allow_unused=True)
    result: Dict[str, List[Any]] = {
        slot + GRAD_SUFFIX: [None] * len(inputs[slot]) for slot in want}
    for (slot, i, t), g in zip(leaves, grads):
        result[slot + GRAD_SUFFIX][i] = torch.zeros_like(t) if g is None \
            else g
    return result
