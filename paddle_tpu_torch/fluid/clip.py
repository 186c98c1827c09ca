"""Gradient / error clipping (counterpart of ``paddle_tpu/fluid/clip.py``):
the hooks ``Optimizer.minimize`` calls, the AMP loss scaler's
``append_unscale_ops``, error clipping (``ErrorClipByValue``: a ``clip``
op over a grad, appended as the backward emits it) and the gradient
clips (``GradientClipByValue``: ``clip``; ``GradientClipByNorm``:
``clip_by_norm``; ``GradientClipByGlobalNorm``: every grad of a group
scaled by ``clip_norm / max(clip_norm, global norm)``).  The clip ops
come after the unscale ops and before the update ops, so a run of
``adam`` / ``momentum`` ops stays one group launch.  The unscale op is
an ``elementwise_div``, which refuses a SelectedRows grad (a sparse
table under the fp16 scaler), as the reference's does."""

from __future__ import annotations

from .framework import OpRole, default_main_program

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "append_unscale_ops", "error_clip_callback", "set_gradient_clip"]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip a variable's grad to ``[min, max]`` (``min`` defaults to
    ``-max``) where the backward writes it."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max,
                               OpRole.KEY: OpRole.Backward})


def error_clip_callback(block, context):
    op = context["__current_op_desc__"]
    for grad_n in op.output_arg_names:
        if not grad_n.endswith("@GRAD"):
            continue
        fwd_var_name = grad_n[: -len("@GRAD")]
        if not block._has_var_recursive(fwd_var_name):
            continue
        fwd_var = block._var_recursive(fwd_var_name)
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is not None:
            error_clip._append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Each grad clipped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn as _nn

        new_grad = _nn.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    """Each grad scaled down to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn as _nn

        new_grad = _nn.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """The grads of a group scaled by ``clip_norm / max(clip_norm, norm)``,
    ``norm`` the L2 norm of all of them together: a ``reduce_sum`` of
    each grad's squares, their ``sum``, its ``sqrt``, then one
    ``elementwise_mul`` a grad."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters in a group should share clip_norm")
        from .layers import nn as _nn

        local_norm = _nn.reduce_sum(_nn.elementwise_mul(grad, grad))
        context[self.group_name].append(local_norm)
        self.context = context

    def _create_operators(self, param, grad):
        from .layers import nn as _nn, ops as _ops, tensor as _tensor

        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = _tensor.sums(input=self.context[self.group_name])
            group_norm = _ops.sqrt(group_norm)
            clip_var = _tensor.fill_constant(shape=[1], dtype="float32",
                                             value=self.clip_norm)
            group_scale = _nn.elementwise_div(
                clip_var, _nn.elementwise_max(clip_var, group_norm))
            self.context[group_scale_name] = group_scale
        new_grad = _nn.elementwise_mul(grad, self.context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block()._var_recursive(p) if isinstance(p, str)
                  else p for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_unscale_ops(params_grads, loss_scale_var):
    """Divide every raw grad by the dynamic loss scale (``fluid.amp`` fp16
    training), between ``append_backward`` and the clip ops, so clip and
    the update see true gradient magnitudes.  Returns fresh (param, grad)
    pairs; the raw (scaled) grads stay in ``program._params_grads``, which
    the Executor's overflow check reads."""
    from .framework import program_guard
    from .layers import nn as _nn

    res = []
    for p, g in params_grads:
        if g is None:
            res.append((p, g))
            continue
        block = p.block
        with program_guard(block.program):
            new_grad = _nn.elementwise_div(g, loss_scale_var)
        # backward role: the unscale ops go with the backward graph
        block.ops[-1].attrs[OpRole.KEY] = OpRole.Backward
        res.append((p, new_grad))
    return res


def append_gradient_clip_ops(param_grad):
    context = {}
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        clip_attr._process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or \
            NullGradientClipAttr()
        res.append(clip_attr._create_operators(param=p, grad=g))
    return res
