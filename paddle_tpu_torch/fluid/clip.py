"""Gradient / error clipping (counterpart of ``paddle_tpu/fluid/clip.py``):
the hooks ``Optimizer.minimize`` calls, and the AMP loss scaler's
``append_unscale_ops``.  Error clipping (its ``clip`` op) and the
gradient-clip attrs (``GradientClipByValue``, ``ByNorm``,
``ByGlobalNorm``) are not ported yet.  The unscale op is an
``elementwise_div``, which refuses a SelectedRows grad (a sparse table
under the fp16 scaler), as the reference's does."""

from __future__ import annotations

from .framework import OpRole, default_main_program

__all__ = ["append_gradient_clip_ops", "append_unscale_ops",
           "error_clip_callback", "set_gradient_clip"]


def error_clip_callback(block, context):
    op = context["__current_op_desc__"]
    for grad_n in op.output_arg_names:
        if not grad_n.endswith("@GRAD"):
            continue
        fwd_var_name = grad_n[: -len("@GRAD")]
        if not block._has_var_recursive(fwd_var_name):
            continue
        fwd_var = block._var_recursive(fwd_var_name)
        if getattr(fwd_var, "error_clip", None) is not None:
            raise NotImplementedError(
                f"{fwd_var_name}.error_clip: error clipping (the clip op) is "
                f"not ported yet; see ROADMAP.md")


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
