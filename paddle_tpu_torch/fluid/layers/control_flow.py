"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): ``While``, ``Switch``,
``IfElse``, ``DynamicRNN``, ``StaticRNN``, ``ConditionalBlock``, the rank
table and the tensor arrays.  The same builder calls build the same
Program as the reference, blocks and sub-block indices included.

Execution (``fluid/control_flow_exec.py``): a ``while`` op runs its body
as an eager loop while its condition holds (a counter chain rooted in
``fill_constant`` or a LoD stays on the host, so the condition costs no
device sync); ``DynamicRNN`` is the reference's construction (a rank
table, tensor arrays, shrinking memories); ``StaticRNN`` the same loop
over a known step count with stack / unstack arrays; ``IfElse`` splits and
merges rows by a mask read on the host.
"""

from __future__ import annotations

import contextlib

from .. import unique_name
from ..framework import Variable
from ..layer_helper import LayerHelper
from .tensor import fill_constant

__all__ = [
    "While", "Switch", "IfElse", "DynamicRNN", "StaticRNN",
    "increment", "is_empty", "less_than", "equal", "array_length",
    "array_read", "array_write", "create_array", "lod_rank_table",
    "max_sequence_len", "lod_tensor_to_array", "array_to_lod_tensor",
    "shrink_memory", "reorder_lod_tensor_by_rank",
]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool",
                                                         stop_gradient=True)
        cond.shape = x.shape
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool",
                                                         stop_gradient=True)
        cond.shape = x.shape
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool",
                                                         stop_gradient=True)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------


def create_array(dtype):
    helper = LayerHelper("array")
    from .. import core

    return helper.main_program.current_block().create_var(
        name=unique_name.generate("array"), dtype=dtype,
        type=core.VarType.LOD_TENSOR_ARRAY)


def array_write(x, i, array=None):
    """ref: write_to_array."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    if getattr(array, "shape", None) is None and x.shape is not None:
        array.shape = tuple(x.shape)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    out.shape = getattr(array, "shape", None)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def lod_rank_table(x, level=0):
    """ref: lod_rank_table_op.cc."""
    helper = LayerHelper("lod_rank_table")
    from .. import core

    table = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_rank_table"),
        type=core.VarType.LOD_RANK_TABLE)
    table.stop_gradient = True
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_length")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    from .. import core

    array = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_tensor_to_array"), dtype=x.dtype,
        type=core.VarType.LOD_TENSOR_ARRAY)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = getattr(x, "shape", None)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------


class BlockGuard:
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program._rollback()
        return exc_type is None


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super().__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        return super().__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # still roll back out of the sub-block so a caught exception
            # doesn't leave later layers appending into the dead body
            super().__exit__(exc_type, exc_val, exc_tb)
            return False
        self.while_op.status = While.AFTER_WHILE_BLOCK
        self.while_op._complete()
        return super().__exit__(exc_type, exc_val, exc_tb)


class While:
    """ref: control_flow.py:655.  The body runs while the condition holds
    (fluid/control_flow_exec.py)."""

    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if not isinstance(cond, Variable):
            raise TypeError("condition should be a variable")
        self.cond_var = cond
        self.is_test = is_test

    def block(self):
        return WhileGuard(self)

    def _complete(self):
        main_program = self.helper.main_program
        while_block = main_program.current_block()
        parent_block = main_program.block(while_block.parent_idx)

        # X: names read in the body but defined outside it;
        # Out: names written in the body that exist outside it
        written = set()
        x_names, out_names = [], []
        for op in while_block.ops:
            for n in op.input_arg_names:
                if not n or n in written or n in x_names:
                    continue
                if parent_block._has_var_recursive(n):
                    x_names.append(n)
            for n in op.output_arg_names:
                if not n:
                    continue
                written.add(n)
                if parent_block._has_var_recursive(n) and n not in out_names:
                    out_names.append(n)
        if self.cond_var.name not in x_names:
            x_names.append(self.cond_var.name)

        from .. import core

        step_scope = parent_block.create_var(
            name=unique_name.generate("_step_scopes"),
            type=core.VarType.STEP_SCOPES)
        parent_block.append_op(
            type="while",
            inputs={"X": x_names, "Condition": [self.cond_var.name]},
            outputs={"Out": out_names, "StepScopes": [step_scope.name]},
            attrs={"sub_block": while_block.idx,
                   "is_test": self.is_test})


# ---------------------------------------------------------------------------
# DynamicRNN (ref: control_flow.py:1542)
# ---------------------------------------------------------------------------


class DynamicRNN:
    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.lod_rank_table = None
        self.max_seq_len = None
        self.step_idx = None
        self.zero_idx = fill_constant(shape=[1], dtype="int64", value=0, force_cpu=True)
        self.mem_dict = {}
        self.output_array = []
        self.outputs = []
        self.cond = self.helper.create_variable_for_type_inference(
            dtype="bool")
        self.cond.stop_gradient = True
        self.while_op = None
        self.input_array = []
        self.mem_link = []

    def step_input(self, x):
        self._assert_in_rnn_block_("step_input")
        parent_block = self._parent_block_()
        from .. import core

        if self.lod_rank_table is None:
            self.lod_rank_table = parent_block.create_var(
                name=unique_name.generate("lod_rank_table"),
                type=core.VarType.LOD_RANK_TABLE)
            self.lod_rank_table.stop_gradient = True
            parent_block.append_op(
                type="lod_rank_table", inputs={"X": [x]},
                outputs={"Out": [self.lod_rank_table]}, attrs={"level": 0})
            self.max_seq_len = parent_block.create_var(
                name=unique_name.generate("dynamic_rnn_max_seq_len"),
                dtype="int64")
            self.max_seq_len.stop_gradient = True
            parent_block.append_op(
                type="max_sequence_len",
                inputs={"RankTable": [self.lod_rank_table]},
                outputs={"Out": [self.max_seq_len]})
            parent_block.append_op(
                type="less_than",
                inputs={"X": [self.step_idx], "Y": [self.max_seq_len]},
                outputs={"Out": [self.cond]})

        input_array = parent_block.create_var(
            name=unique_name.generate("dynamic_rnn_input_array"),
            dtype=x.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
        if x.shape is not None:
            input_array.shape = (-1,) + tuple(x.shape[1:])
        self.input_array.append((input_array, x.dtype))
        parent_block.append_op(
            type="lod_tensor_to_array",
            inputs={"X": [x], "RankTable": [self.lod_rank_table]},
            outputs={"Out": [input_array]})
        return array_read(array=input_array, i=self.step_idx)

    def static_input(self, x):
        self._assert_in_rnn_block_("static_input")
        if self.lod_rank_table is None:
            raise RuntimeError(
                "static_input() must be called after step_input().")
        parent_block = self._parent_block_()
        x_reordered = parent_block.create_var(
            name=unique_name.generate("dynamic_rnn_static_input_reordered"),
            dtype=x.dtype)
        x_reordered.shape = getattr(x, "shape", None)
        parent_block.append_op(
            type="reorder_lod_tensor_by_rank",
            inputs={"X": [x], "RankTable": [self.lod_rank_table]},
            outputs={"Out": [x_reordered]})
        return shrink_memory(x_reordered, self.step_idx, self.lod_rank_table)

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be invoked once")
        self.step_idx = fill_constant(shape=[1], dtype="int64", value=0, force_cpu=True)
        self.step_idx.stop_gradient = False
        self.status = DynamicRNN.IN_RNN
        self.while_op = While(cond=self.cond)
        with self.while_op.block():
            yield
            increment(x=self.step_idx, value=1.0, in_place=True)
            for new_mem, mem_array in self.mem_link:
                array_write(x=new_mem, i=self.step_idx, array=mem_array)
            less_than(x=self.step_idx, y=self.max_seq_len, cond=self.cond)
        self.status = DynamicRNN.AFTER_RNN
        for each_array in self.output_array:
            self.outputs.append(
                array_to_lod_tensor(x=each_array, table=self.lod_rank_table))

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("Dynamic RNN outputs can only be visited "
                             "outside the rnn block.")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn_block_("memory")
        parent_block = self._parent_block_()
        from .. import core

        if init is not None:
            if self.lod_rank_table is None:
                raise ValueError(
                    "DynamicRNN.memory() requires a prior step_input() — "
                    "the rank table defines the shrinking batch order")
            init_tensor = init
            if need_reorder:
                init_reordered = parent_block.create_var(
                    name=unique_name.generate(
                        "dynamic_rnn_mem_init_reordered"), dtype=init.dtype)
                init_reordered.shape = getattr(init, "shape", None)
                parent_block.append_op(
                    type="reorder_lod_tensor_by_rank",
                    inputs={"X": [init_tensor],
                            "RankTable": [self.lod_rank_table]},
                    outputs={"Out": [init_reordered]})
                init_tensor = init_reordered
            mem_array = parent_block.create_var(
                name=unique_name.generate("dynamic_rnn_mem_array"),
                dtype=init.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
            mem_array.shape = getattr(init_tensor, "shape", None)
            parent_block.append_op(
                type="write_to_array",
                inputs={"X": [init_tensor], "I": [self.zero_idx]},
                outputs={"Out": [mem_array]})
            retv = array_read(array=mem_array, i=self.step_idx)
            retv = shrink_memory(x=retv, i=self.step_idx,
                                 table=self.lod_rank_table)
            self.mem_dict[retv.name] = mem_array
            return retv
        else:
            if len(self.input_array) == 0:
                raise ValueError(
                    "step_input should be invoked before memory(shape=...)")
            init = parent_block.create_var(
                name=unique_name.generate("mem_init"), dtype=dtype,
                shape=[-1] + list(shape))
            arr, arr_dtype = self.input_array[0]
            in0 = parent_block.create_var(
                name=unique_name.generate("in0"), dtype=arr_dtype)
            parent_block.append_op(
                type="read_from_array",
                inputs={"X": [arr], "I": [self.zero_idx]},
                outputs={"Out": [in0]})
            parent_block.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [in0]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape), "value": float(value),
                       "dtype": init.dtype, "input_dim_idx": 0,
                       "output_dim_idx": 0})
            return self.memory(init=init)

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block_("update_memory")
        mem_array = self.mem_dict.get(ex_mem.name)
        if mem_array is None:
            raise ValueError("Please invoke memory before update_memory")
        self.mem_link.append((new_mem, mem_array))

    def output(self, *outputs):
        self._assert_in_rnn_block_("output")
        parent_block = self._parent_block_()
        from .. import core

        for each in outputs:
            outside_array = parent_block.create_var(
                name=unique_name.generate("_".join(
                    [self.helper.name, "output_array", each.name])),
                dtype=each.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
            array_write(x=each, i=self.step_idx, array=outside_array)
            self.output_array.append(outside_array)

    def _parent_block_(self):
        prog = self.helper.main_program
        parent_idx = prog.current_block().parent_idx
        assert parent_idx >= 0
        return prog.block(parent_idx)

    def _assert_in_rnn_block_(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method} can only be invoked inside rnn block")


# ---------------------------------------------------------------------------
# StaticRNN (ref: control_flow.py:430 — fixed-length sequences; input layout
# [T, B, ...], stepping over dim 0)
# ---------------------------------------------------------------------------


class StaticRNN:
    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None
        self.step_idx = None
        self.zero_idx = fill_constant(shape=[1], dtype="int64", value=0, force_cpu=True)
        self.cond = self.helper.create_variable_for_type_inference(
            dtype="bool")
        self.cond.stop_gradient = True
        self.while_op = None
        self.mem_dict = {}
        self.mem_link = []
        self.output_array = []
        self.outputs = []
        self.input_arrays = []
        self._len_const = None

    @contextlib.contextmanager
    def step(self):
        if self.status != StaticRNN.BEFORE_RNN_BLOCK:
            raise ValueError("step() can only be invoked once")
        self.step_idx = fill_constant(shape=[1], dtype="int64", value=0, force_cpu=True)
        self.status = StaticRNN.IN_RNN_BLOCK
        self.while_op = While(cond=self.cond)
        guard = self.while_op.block()
        guard.__enter__()
        try:
            yield
        except BaseException:
            guard.__exit__(*__import__("sys").exc_info())
            raise
        else:
            increment(x=self.step_idx, value=1.0, in_place=True)
            for new_mem, mem_array in self.mem_link:
                array_write(x=new_mem, i=self.step_idx, array=mem_array)
            less_than(x=self.step_idx, y=self._len_const, cond=self.cond)
            self.status = StaticRNN.AFTER_RNN_BLOCK
            guard.__exit__(None, None, None)
            self._finalize()

    def step_input(self, x):
        self._assert_in_rnn_block_("step_input")
        if x.shape is None or x.shape[0] in (None, -1):
            raise ValueError("StaticRNN step_input needs a static sequence "
                             "length as dim 0 ([T, B, ...] layout)")
        seq_len = int(x.shape[0])
        if self.seq_len is None:
            self.seq_len = seq_len
        elif self.seq_len != seq_len:
            raise ValueError("all StaticRNN step inputs must share dim 0")
        parent_block = self._parent_block_()
        if self._len_const is None:
            with _block_guard_ctx(self.helper.main_program, parent_block):
                self._len_const = fill_constant(shape=[1], dtype="int64", value=seq_len,
                                              force_cpu=True)
                less_than(x=self.step_idx, y=self._len_const, cond=self.cond)
        from .. import core

        input_array = parent_block.create_var(
            name=unique_name.generate("static_rnn_input_array"),
            dtype=x.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
        input_array.shape = tuple(x.shape[1:])
        parent_block.append_op(
            type="tensor_array_unstack", inputs={"X": [x]},
            outputs={"Out": [input_array]})
        self.input_arrays.append(input_array)
        return array_read(array=input_array, i=self.step_idx)

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block_("memory")
        parent_block = self._parent_block_()
        from .. import core

        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape and batch_ref)")
            if not self.input_arrays:
                raise ValueError("memory(batch_ref=...) requires a prior "
                                 "step_input")
            # batch_ref is body-local; derive the batch from the parent-
            # visible step-0 slice of the first input array instead
            arr0 = self.input_arrays[0]
            in0 = parent_block.create_var(
                name=unique_name.generate("static_rnn_in0"),
                dtype=arr0.dtype, shape=getattr(arr0, "shape", None))
            parent_block.append_op(
                type="read_from_array",
                inputs={"X": [arr0], "I": [self.zero_idx]},
                outputs={"Out": [in0]})
            init = parent_block.create_var(
                name=unique_name.generate("static_rnn_mem_init"),
                dtype=batch_ref.dtype,
                shape=[-1] + list(shape[1:] if shape and shape[0] in
                                  (-1, None) else shape))
            mem_shape = list(shape)
            if mem_shape and mem_shape[0] in (-1, None):
                mem_shape = mem_shape[1:]
            parent_block.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [in0]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + mem_shape,
                       "value": float(init_value), "dtype": init.dtype,
                       "input_dim_idx": 0,
                       "output_dim_idx": init_batch_dim_idx})
        mem_array = parent_block.create_var(
            name=unique_name.generate("static_rnn_mem_array"),
            dtype=init.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
        mem_array.shape = getattr(init, "shape", None)
        parent_block.append_op(
            type="write_to_array",
            inputs={"X": [init], "I": [self.zero_idx]},
            outputs={"Out": [mem_array]})
        retv = array_read(array=mem_array, i=self.step_idx)
        self.mem_dict[retv.name] = mem_array
        return retv

    def update_memory(self, mem, var):
        self._assert_in_rnn_block_("update_memory")
        mem_array = self.mem_dict.get(mem.name)
        if mem_array is None:
            raise ValueError("update_memory: unknown memory")
        self.mem_link.append((var, mem_array))

    def step_output(self, o):
        self._assert_in_rnn_block_("step_output")
        parent_block = self._parent_block_()
        from .. import core

        out_array = parent_block.create_var(
            name=unique_name.generate("static_rnn_output_array"),
            dtype=o.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
        array_write(x=o, i=self.step_idx, array=out_array)
        self.output_array.append(out_array)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        helper = LayerHelper("static_rnn_out")
        for arr in self.output_array:
            out = helper.create_variable_for_type_inference(dtype=arr.dtype)
            helper.append_op(type="tensor_array_stack",
                             inputs={"X": [arr]}, outputs={"Out": [out]})
            self.outputs.append(out)

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("outputs readable only after the step block")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs

    def _parent_block_(self):
        prog = self.helper.main_program
        return prog.block(prog.current_block().parent_idx)

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError(f"{method} must be called inside step()")


@contextlib.contextmanager
def _block_guard_ctx(program, block):
    """Temporarily append ops into an outer block."""
    saved = program.current_block_idx
    program.current_block_idx = block.idx
    try:
        yield
    finally:
        program.current_block_idx = saved


# ---------------------------------------------------------------------------
# IfElse / Switch
# ---------------------------------------------------------------------------


class IfElse:
    """ref: control_flow.py IfElse — split rows by a bool mask, run both
    branches on their subsets, merge."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = [[], []]  # [false, true]

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be inside true_block/false_block")
        branch = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        if x.name not in self.input_table:
            helper = LayerHelper("split_lod_tensor")
            out_true = helper.create_variable_for_type_inference(x.dtype)
            out_false = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op(
                type="split_lod_tensor",
                inputs={"X": [x], "Mask": [self.cond]},
                outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                attrs={"level": 0})
            self.input_table[x.name] = (out_true, out_false)
        out_true, out_false = self.input_table[x.name]
        return out_true if branch else out_false

    @contextlib.contextmanager
    def true_block(self):
        self.status = IfElse.IN_IF_ELSE_TRUE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def false_block(self):
        self.status = IfElse.IN_IF_ELSE_FALSE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be inside a branch block")
        branch = 1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0
        self.output_table[branch].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-blocks")
        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            raise ValueError("true/false blocks must declare equal outputs")
        rets = []
        helper = LayerHelper("merge_lod_tensor")
        for t, f in zip(true_outs, false_outs):
            out = helper.create_variable_for_type_inference(t.dtype)
            helper.append_op(
                type="merge_lod_tensor",
                inputs={"InTrue": [t], "InFalse": [f], "Mask": [self.cond],
                        "X": [self.cond]},
                outputs={"Out": [out]}, attrs={"level": 0})
            rets.append(out)
        return rets[0] if len(rets) == 1 else rets


class ConditionalBlock:
    """ref: conditional_block_op.cc wrapper used by Switch."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        prog._create_block()
        yield
        cond_block = prog.current_block()
        prog._rollback()
        parent_block = prog.current_block()

        written = set()
        in_names, out_names = [], []
        for op in cond_block.ops:
            for n in op.input_arg_names:
                if n and n not in written and n not in in_names and \
                        parent_block._has_var_recursive(n):
                    in_names.append(n)
            for n in op.output_arg_names:
                if not n:
                    continue
                written.add(n)
                if parent_block._has_var_recursive(n) and n not in out_names:
                    out_names.append(n)
        from .. import core

        step_scope = parent_block.create_var(
            name=unique_name.generate("_cond_scopes"),
            type=core.VarType.STEP_SCOPES)
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [c.name for c in self.inputs],
                    "Input": in_names},
            outputs={"Out": out_names, "Scope": [step_scope.name]},
            attrs={"sub_block": cond_block.idx,
                   "is_scalar_condition": self.is_scalar_condition})


class Switch:
    """ref: control_flow.py Switch — scalar-condition case chain built on
    conditional_block."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case should be called inside with")
        from .ops import logical_and, logical_not

        if len(self.pre_not_conditions) == 0:
            cond_block = ConditionalBlock([condition],
                                          is_scalar_condition=True)
            not_cond = logical_not(x=condition)
            self.pre_not_conditions.append(not_cond)
        else:
            pre_cond_num = len(self.pre_not_conditions)
            pre_not_cond = self.pre_not_conditions[pre_cond_num - 1]
            new_not_cond = logical_and(
                x=pre_not_cond, y=logical_not(x=condition))
            self.pre_not_conditions.append(new_not_cond)
            cond_block = ConditionalBlock(
                [logical_and(x=pre_not_cond, y=condition)],
                is_scalar_condition=True)
        with cond_block.block():
            yield

    @contextlib.contextmanager
    def default(self):
        pre_cond_num = len(self.pre_not_conditions)
        if pre_cond_num == 0:
            raise ValueError("there should be at least one condition")
        cond_block = ConditionalBlock(
            [self.pre_not_conditions[pre_cond_num - 1]],
            is_scalar_condition=True)
        with cond_block.block():
            yield

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        return exc_type is None
