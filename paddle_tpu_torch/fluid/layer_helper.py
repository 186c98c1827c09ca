"""LayerHelper: shared param-creation/op-append plumbing for layers
(counterpart of ``paddle_tpu/fluid/layer_helper.py``)."""

from __future__ import annotations

from . import core, unique_name
from .framework import Variable, default_main_program, default_startup_program
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [attr[0]] + [ParamAttr(**attr[0].__dict__.copy())
                                for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        for i, a in zip(inputs, attrs):
            yield i, a

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for i in inputs:
            if dtype is None:
                dtype = i.dtype
            elif dtype != i.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = attr if isinstance(attr, ParamAttr) else ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))
        gb = self.main_program.global_block()
        if gb.has_var(attr.name):
            # named reuse = weight tying (the scope is name-keyed); refuse a
            # shape/dtype mismatch here, where the offending layer is known
            existing = gb.var(attr.name)
            if tuple(existing.shape) != tuple(shape) \
                    or core.convert_dtype(existing.dtype) \
                    != core.convert_dtype(dtype):
                raise ValueError(
                    f"parameter {attr.name!r} reused with shape {shape} "
                    f"dtype {dtype}, but it already exists with shape "
                    f"{existing.shape} dtype {existing.dtype}")
            return existing
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs(with_initializer=True))
        attr.initializer(sp, startup_block)
        # mirror in the main program
        return gb.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, persistable=False, stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, stop_gradient=True, **kwargs)

    def set_variable_initializer(self, var, initializer):
        self.startup_program.global_block().create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)
        initializer(var, self.startup_program.global_block())
        return var

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type="elementwise_add", inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
