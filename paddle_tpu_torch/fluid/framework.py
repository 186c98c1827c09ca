"""Program IR: Variable / Operator / Block / Program (counterpart of
``paddle_tpu/fluid/framework.py``).

The IR is backend-neutral: the same builder calls produce the same ops,
names, attrs, shapes and dtypes in both packages.  Only execution differs —
the port's Executor runs a block eagerly op by op with PyTorch instead of
tracing it into one XLA program.

``Program.clone(for_test=True)``, ``_prune`` and ``inference_optimize``
follow the reference's rules exactly, so a test or inference program is the
same in both packages.  ``serialize_to_string`` pickles the program as the
reference does, but ``parse_from_string`` unpickles only this package's
classes: a program the JAX package wrote names ``paddle_tpu`` classes, and
loading them would import JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import pickle
from collections import OrderedDict
from typing import Dict, List, Optional

from . import core, unique_name

GRAD_VAR_SUFFIX = "@GRAD"
TEMP_VAR_NAME = "@TEMP@"
#: the scope name under which the Executor keeps its random generators
RNG_STATE_VAR = "@RNG_STATE@"


class OpRole:
    """Op role attr (ref: op_proto_maker.h); every op carries one.
    ``append_backward`` and the optimizers read and write it."""

    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256

    KEY = "op_role"
    VAR_KEY = "op_role_var"


def grad_var_name(name: str) -> str:
    return name + GRAD_VAR_SUFFIX


class Variable:
    """A named value in a Block.  Shapes may hold -1 (batch); the concrete
    shape comes from the fed or stored tensor at run time."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, type=core.VarType.LOD_TENSOR, error_clip=None,
                 **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate(TEMP_VAR_NAME)
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = core.convert_dtype(dtype) if type == core.VarType.LOD_TENSOR else dtype
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.error_clip = error_clip

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def to_string(self, throw_on_error=False, with_details=False):
        return (f"var {self.name} : shape{self.shape} dtype={self.dtype} "
                f"persistable={self.persistable} stop_gradient={self.stop_gradient}")

    __repr__ = __str__ = lambda self: self.to_string()

    def _clone_into(self, block):
        v = copy.copy(self)
        v.block = block
        return v


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter needs shape and dtype")
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("stop_gradient", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)


class Operator:
    """One op in a block: type + named input/output slots + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_slot_map(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_slot_map(outputs)
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.attrs.setdefault(OpRole.KEY, OpRole.Forward)

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def to_string(self, throw_on_error=False):
        ins = ", ".join(f"{k}={v}" for k, v in sorted(self.inputs.items()))
        outs = ", ".join(f"{k}={v}" for k, v in sorted(self.outputs.items()))
        sig_attrs = {k: v for k, v in self.attrs.items()
                     if k not in (OpRole.KEY, OpRole.VAR_KEY)}
        return f"{{{outs}}} = {self.type}(inputs=[{ins}], attrs={sig_attrs})"

    __repr__ = __str__ = lambda self: self.to_string()


def _normalize_slot_map(m) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = OrderedDict()
    if not m:
        return out
    for slot, vals in m.items():
        if vals is None:
            out[slot] = []
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        names = []
        for v in vals:
            if v is None:
                continue
            names.append(v.name if isinstance(v, Variable) else str(v))
        out[slot] = names
    return out


class Block:
    """Ordered ops + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = OrderedDict()
        self.ops: List[Operator] = []
        # forward-block link used by grad ops of sub-blocks
        self.forward_block_idx = -1

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        p = Parameter(self, **kwargs)
        # parameters always live in the outermost (global) block
        gb = self.program.global_block()
        p.block = gb
        gb.vars[p.name] = p
        self.program._bump_version()
        return p

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"var {name} not in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _var_recursive(self, name: str) -> Variable:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise ValueError(f"var {name} not found from block {self.idx} upward")

    def _has_var_recursive(self, name: str) -> bool:
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent_block
        return False

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type=None, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def to_string(self, throw_on_error=False, with_details=False):
        lines = [f"-- block {self.idx} (parent {self.parent_idx}) --"]
        for v in self.vars.values():
            lines.append("  " + v.to_string())
        for op in self.ops:
            lines.append("  " + op.to_string())
        return "\n".join(lines)


class Program:
    """A whole computation: list of blocks.  ``_version`` is bumped on every
    mutation; the Executor keys its plan cache on (token, version)."""

    _token_counter = 0

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        Program._token_counter += 1
        self._cache_token = Program._token_counter
        self._is_test = False

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # ---- clone / prune ----
    def clone(self, for_test=False) -> "Program":
        """A copy with its own identity (plan cache token).  ``for_test``:
        ``dropout`` and ``batch_norm`` get ``is_test``, and the
        Backward-role and Optimize-role ops go (ops of every other role,
        a learning-rate schedule's included, stay)."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            nb.forward_block_idx = b.forward_block_idx
            for v in b.vars.values():
                nb.vars[v.name] = v._clone_into(nb)
            for op in b.ops:
                nop = Operator(nb, op.type, copy.deepcopy(op.inputs),
                               copy.deepcopy(op.outputs),
                               copy.deepcopy(op.attrs))
                if for_test and "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        p._is_test = for_test
        if for_test:
            for b in p.blocks:
                b.ops = [op for op in b.ops
                         if op.attr(OpRole.KEY, OpRole.Forward)
                         & OpRole.Backward == 0
                         and op.attr(OpRole.KEY, OpRole.Forward)
                         != OpRole.Optimize]
        return p

    def _prune(self, targets, drop_roles=()) -> "Program":
        """A clone keeping only the global block's ops needed to produce
        ``targets`` (Variables or names); ops whose role has a bit of
        ``drop_roles`` go first."""
        target_names = {t.name if isinstance(t, Variable) else str(t)
                        for t in targets}
        drop = 0
        for r in drop_roles:
            drop |= int(r)
        p = self.clone()
        gb = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(gb.ops):
            role = int(op.attrs.get(OpRole.KEY, OpRole.Forward))
            if drop and (role & drop):
                continue
            if any(n in needed for n in op.output_arg_names):
                kept.append(op)
                needed.update(op.input_arg_names)
        gb.ops = list(reversed(kept))
        return p

    def inference_optimize(self) -> "Program":
        return self.clone(for_test=True)

    # ---- serialization: a versioned pickle, as the reference writes ----
    SERIAL_VERSION = 1

    def serialize_to_string(self) -> bytes:
        return pickle.dumps({"version": self.SERIAL_VERSION,
                             "program": self})

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        payload = safe_loads(data)
        if isinstance(payload, Program):  # pre-versioned blobs
            return payload
        if payload.get("version") != Program.SERIAL_VERSION:
            raise ValueError(
                f"program blob version {payload.get('version')} != "
                f"{Program.SERIAL_VERSION}")
        return payload["program"]

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()


# Ops that behave differently under test mode.
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}

# what an unpickled program may name besides this package's classes: the
# containers the IR holds, and numpy (arrays and scalars in op attrs)
_SAFE_BUILTINS = frozenset([
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple"])


class _PortUnpickler(pickle.Unpickler):
    """Resolves only ``paddle_tpu_torch`` classes, numpy, ``OrderedDict``
    and the plain builtin types; anything else raises ``ValueError``
    before its module is imported."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if (root in ("paddle_tpu_torch", "numpy")
                or (module == "builtins" and name in _SAFE_BUILTINS)
                or (module == "collections" and name == "OrderedDict")):
            return super().find_class(module, name)
        if root == "paddle_tpu":
            raise ValueError(
                f"this program was written by another package ({module}."
                f"{name}): rebuild it with paddle_tpu_torch's builders; its "
                f"per-variable files load as they are (fluid.io.load_vars)")
        raise ValueError(f"a pickled program may not name {module}.{name}")


def safe_loads(data: bytes):
    """``pickle.loads`` through :class:`_PortUnpickler`."""
    return _PortUnpickler(io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# default programs & guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


@contextlib.contextmanager
def name_scope(prefix=None):
    """A context manager that changes nothing: in the reference it only
    names ops for display."""
    yield


def fresh_session():
    """Reset ALL build-session globals: default programs, unique-name
    counters, global scope."""
    from . import executor as _executor
    from . import unique_name as _unique_name

    switch_main_program(Program())
    switch_startup_program(Program())
    _unique_name.switch()
    _executor._global_scope = _executor.Scope()
