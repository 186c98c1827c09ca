"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``):
sgd, momentum and adam, each updating its state IN PLACE.
Momentum and adam also register a group hook: the Executor hands a run of
consecutive such ops with equal attrs to it at once, and one kernel
launch updates every parameter of the run.
A SelectedRows grad (``lookup_table(is_sparse=True)``) reaches sgd as it
is: only the looked-up rows move.  Momentum and adam fold it into a dense
grad first (:func:`_grad`), as the reference does.  The other optimizers'
ops (adagrad, adamax, decayed_adagrad, adadelta, rmsprop, ftrl,
proximal_gd, proximal_adagrad) are not registered yet: their programs
build, and running them raises ``NotImplementedError``."""

from __future__ import annotations

from . import fused
from .registry import register_group, register_op


def _lr(ctx):
    return ctx.input("LearningRate").reshape(1)


def _grad(ctx):
    """The Grad input as a dense contiguous tensor: a SelectedRows grad is
    folded by scatter-add, so the moment-carrying updates run their dense
    semantics (the reference's deliberate departure from a row-lazy
    sparse adam)."""
    from ..fluid.selected_rows import SelectedRows

    g = ctx.input("Grad")
    if isinstance(g, SelectedRows):
        p = ctx.input("Param")
        return g.to_dense(p.shape[0]).to(p.dtype)
    return g.contiguous()


@register_op("sgd", no_grad_inputs=("Param", "Grad", "LearningRate"))
def sgd(ctx):
    """``Param -= lr · Grad`` in place.  A SelectedRows grad touches only
    the looked-up rows (``lr · value`` subtracted at each occurrence, so
    duplicate ids fold in the scatter-add); every other row keeps its
    bits."""
    from ..fluid.selected_rows import SelectedRows

    p, g = ctx.input("Param"), ctx.input("Grad")
    if isinstance(g, SelectedRows):
        g.scatter_sub_into(p, _lr(ctx))
    else:
        p.sub_(_lr(ctx) * g)
    return {"ParamOut": p}


@register_op("momentum", no_grad_inputs=("Param", "Grad", "Velocity",
                                         "LearningRate"))
def momentum(ctx):
    """``Param`` and ``Velocity`` are updated IN PLACE and returned as
    ``ParamOut`` and ``VelocityOut``, which the Program names like the
    inputs: a group of one (:func:`momentum_group`)."""
    return momentum_group([ctx])[0]


@register_group("momentum")
def momentum_group(ctxs):
    """A run of momentum ops with one ``mu`` and ``use_nesterov``, as one
    :func:`fused.momentum_group` call (one launch on the card, the plain
    version on the CPU); each op's ``LearningRate`` is its own."""
    ps = [c.input("Param") for c in ctxs]
    vs = [c.input("Velocity") for c in ctxs]
    fused.momentum_group(ps, [_grad(c) for c in ctxs],
                         vs, [c.input("LearningRate") for c in ctxs],
                         ctxs[0].attr("mu"),
                         ctxs[0].attr("use_nesterov", False))
    return [{"ParamOut": p, "VelocityOut": v} for p, v in zip(ps, vs)]


@register_op("adam", no_grad_inputs=("Param", "Grad", "LearningRate",
                                     "Moment1", "Moment2", "Beta1Pow",
                                     "Beta2Pow"))
def adam(ctx):
    """``Param``, ``Moment1``, ``Moment2`` and the beta pows are updated IN
    PLACE and returned as ``ParamOut`` etc., which the Program names like
    the inputs: a group of one (:func:`adam_group`)."""
    return adam_group([ctx])[0]


@register_group("adam")
def adam_group(ctxs):
    """A run of adam ops with one ``beta1``, ``beta2`` and ``epsilon``, as
    one :func:`fused.adam_group` call (one launch on the card, the plain
    version on the CPU).  The bias-corrected ``lr·√(1 − β2ᵗ)/(1 − β1ᵗ)``
    and the beta-pow updates, which the reference computes as scalar math
    outside its kernel, happen inside it: no host sync and no small
    launches per parameter."""
    c0 = ctxs[0]
    ps = [c.input("Param") for c in ctxs]
    m1s = [c.input("Moment1") for c in ctxs]
    m2s = [c.input("Moment2") for c in ctxs]
    b1ps, b2ps = fused.adam_group(
        ps, [_grad(c) for c in ctxs], m1s, m2s,
        [c.input("LearningRate") for c in ctxs],
        [c.input("Beta1Pow") for c in ctxs],
        [c.input("Beta2Pow") for c in ctxs], c0.attr("beta1", 0.9),
        c0.attr("beta2", 0.999), c0.attr("epsilon", 1e-8))
    return [{"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p}
            for p, m1, m2, b1p, b2p in zip(ps, m1s, m2s, b1ps, b2ps)]
