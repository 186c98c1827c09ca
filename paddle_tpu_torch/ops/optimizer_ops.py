"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``):
sgd (dense grads), momentum and adam, each updating its state IN PLACE.
The other optimizers' ops (adagrad, adamax, decayed_adagrad, adadelta,
rmsprop, ftrl, proximal_gd, proximal_adagrad) and sgd's SelectedRows grad
are not registered yet: their programs build, and running them raises
``NotImplementedError``."""

from __future__ import annotations

from . import fused
from .registry import register_op


def _lr(ctx):
    return ctx.input("LearningRate").reshape(1)


@register_op("sgd", no_grad_inputs=("Param", "Grad", "LearningRate"))
def sgd(ctx):
    """``Param -= lr · Grad`` in place (dense grads only: the sparse
    SelectedRows grad comes with ``lookup_table(is_sparse=True)``)."""
    p = ctx.input("Param")
    p.sub_(_lr(ctx) * ctx.input("Grad"))
    return {"ParamOut": p}


@register_op("momentum", no_grad_inputs=("Param", "Grad", "Velocity",
                                         "LearningRate"))
def momentum(ctx):
    """``Param`` and ``Velocity`` are updated IN PLACE by
    :func:`fused.momentum` (the kernel on the card, its plain version on
    the CPU) and returned as ``ParamOut`` and ``VelocityOut``, which the
    Program names like the inputs."""
    p, v = ctx.input("Param"), ctx.input("Velocity")
    fused.momentum(p, ctx.input("Grad").contiguous(), v, _lr(ctx),
                   ctx.attr("mu"), ctx.attr("use_nesterov", False))
    return {"ParamOut": p, "VelocityOut": v}


@register_op("adam", no_grad_inputs=("Param", "Grad", "LearningRate",
                                     "Moment1", "Moment2", "Beta1Pow",
                                     "Beta2Pow"))
def adam(ctx):
    """``Param``, ``Moment1`` and ``Moment2`` are updated IN PLACE by
    :func:`fused.adam` (the kernel on the card, its plain version on the
    CPU) and returned as ``ParamOut`` etc., which the Program names like
    the inputs.  The bias-corrected ``lr_eff`` and the beta-pow updates
    are ``[1]`` tensors on the device, as the reference computes them
    outside its kernel: no host sync per parameter."""
    p, m1, m2 = ctx.input("Param"), ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_eff = _lr(ctx) * (1.0 - b2p.reshape(1)).sqrt() / (1.0 - b1p.reshape(1))
    fused.adam(p, ctx.input("Grad").contiguous(), m1, m2, lr_eff, b1, b2,
               eps)
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": (b1p * b1).reshape(1),
            "Beta2PowOut": (b2p * b2).reshape(1)}
