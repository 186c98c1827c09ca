"""Operator registry: op type -> PyTorch implementation (counterpart of
``paddle_tpu/ops/registry.py``).

An op impl is a plain function ``fn(ctx) -> {slot: tensor | [tensors]}``
over the tensors the Executor hands it; it runs eagerly on whatever device
those tensors lie on.  Forward only: the generic gradient comes with the
training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class ExecContext:
    """What an op impl sees: input tensors by slot, attrs, the output names
    it must produce, the device ops that create tensors put them on, and
    the generator random ops draw from."""

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

    def has_input(self, slot: str) -> bool:
        return bool(self.inputs.get(slot))

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)


class OpDef:
    """``stateful``: the op draws random numbers (the executor seeds a
    generator for the run)."""

    __slots__ = ("type", "fn", "stateful")

    def __init__(self, type, fn, stateful=False):
        self.type = type
        self.fn = fn
        self.stateful = stateful


REGISTRY: Dict[str, OpDef] = {}


def register_op(op_type: str, *, stateful: bool = False) -> Callable:
    """Decorator: register ``fn(ctx) -> {slot: tensor | [tensors]}``."""

    def deco(fn):
        if op_type in REGISTRY:
            raise ValueError(f"op {op_type} registered twice")
        REGISTRY[op_type] = OpDef(op_type, fn, stateful=stateful)
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
