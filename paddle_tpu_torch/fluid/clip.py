"""Gradient / error clipping (counterpart of ``paddle_tpu/fluid/clip.py``):
the hooks ``Optimizer.minimize`` calls.  Error clipping (its ``clip`` op),
the gradient-clip attrs (``GradientClipByValue``, ``ByNorm``,
``ByGlobalNorm``) and the AMP ``append_unscale_ops`` are not ported yet."""

from __future__ import annotations

from .framework import default_main_program

__all__ = ["append_gradient_clip_ops", "error_clip_callback",
           "set_gradient_clip"]


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
