"""Optimizer update ops (counterpart of ``paddle_tpu/ops/optimizer_ops.py``):
sgd, momentum, adam, rmsprop, adagrad, adamax, decayed_adagrad, adadelta,
ftrl, proximal_gd and proximal_adagrad, each updating its state IN PLACE,
and ``average_accumulates`` (``ModelAverage``'s running sums).

Every type but sgd and rmsprop also registers a group impl: the Executor
hands a run of consecutive such ops with equal attrs to it at once.  For
momentum and adam one kernel launch updates every parameter of the run
(``fused.py``); the others are plain PyTorch (the reference has no
Pallas kernel for them) over ``torch._foreach_*`` calls, one call a step
of the reference's arithmetic for the whole run, each rounding once per
element as the per-element op does, so a group gives bitwise what its
members give one by one.  A single op is a group of one.

A SelectedRows grad (``lookup_table(is_sparse=True)``) reaches sgd as it
is: only the looked-up rows move.  Momentum, adam, rmsprop, adagrad,
adamax, decayed_adagrad, adadelta and ftrl fold it into a dense grad
first (:func:`_grad`), as the reference does; proximal_gd and
proximal_adagrad read ``Grad`` as a dense array, as the reference does,
and refuse a SelectedRows."""

from __future__ import annotations

import torch

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


@register_op("rmsprop", no_grad_inputs=("Param", "Grad", "MeanSquare",
                                        "Moment", "LearningRate"))
def rmsprop(ctx):
    """``MeanSquare = decay·MeanSquare + (1 − decay)·g²``, ``Moment =
    momentum·Moment + lr·g / √(MeanSquare + ε)``, ``Param −= Moment``, in
    place, in the reference's order of operations (plain PyTorch: the
    reference's rmsprop is no Pallas kernel)."""
    p, ms, mom = ctx.input("Param"), ctx.input("MeanSquare"), \
        ctx.input("Moment")
    g = _grad(ctx)
    decay = ctx.attr("decay", 0.9)
    ms.mul_(decay).add_((1.0 - decay) * g * g)
    mom.mul_(ctx.attr("momentum", 0.0)).add_(
        _lr(ctx) * g / torch.sqrt(ms + ctx.attr("epsilon", 1e-10)))
    p.sub_(mom)
    return {"ParamOut": p, "MeanSquareOut": ms, "MomentOut": mom}


# ---------------------------------------------------------------------------
# The other optimizers: plain PyTorch over whole runs (torch._foreach_*)
# ---------------------------------------------------------------------------

def _col(ctxs, slot):
    return [c.input(slot) for c in ctxs]


def _lrs(ctxs):
    return [_lr(c) for c in ctxs]


def _decay_into(accs, rate, gs, hs):
    """``acc = rate·acc + (1 − rate)·g·h`` in place, in that order."""
    torch._foreach_mul_(accs, rate)
    t = torch._foreach_mul(gs, 1.0 - rate)
    torch._foreach_mul_(t, hs)
    torch._foreach_add_(accs, t)


def _dense_only(ctxs):
    """The Grad inputs of a proximal op, which reads them as dense arrays
    (a SelectedRows fails there in the reference too)."""
    from ..fluid.selected_rows import SelectedRows

    gs = _col(ctxs, "Grad")
    if any(isinstance(g, SelectedRows) for g in gs):
        raise TypeError(
            f"{ctxs[0].op_type}: Grad is a SelectedRows (a sparse "
            f"lookup_table's grad); this op reads a dense Grad: build the "
            f"embedding with is_sparse=False")
    return gs


def _prox_into(ps, prox, lrs, l1, l2):
    """``p = sign(prox)·max(|prox| − lr·l1, 0) / (1 + lr·l2)``, the
    proximal operator with the scalar lr."""
    a = torch._foreach_abs(prox)
    torch._foreach_sub_(a, torch._foreach_mul(lrs, l1))
    torch._foreach_clamp_min_(a, 0.0)
    out = torch._foreach_sign(prox)
    torch._foreach_mul_(out, a)
    den = torch._foreach_mul(lrs, l2)
    torch._foreach_add_(den, 1.0)
    torch._foreach_div_(out, den)
    torch._foreach_copy_(ps, out)


def _single(group_fn):
    def op(ctx):
        return group_fn([ctx])[0]

    op.__name__ = group_fn.__name__[:-len("_group")]
    op.__doc__ = f"A group of one (:func:`{group_fn.__name__}`)."
    return op


def adagrad_group(ctxs):
    """``Moment += g·g``, ``Param −= lr·g / (√Moment + ε)``."""
    ps, ms, gs = _col(ctxs, "Param"), _col(ctxs, "Moment"), \
        [_grad(c) for c in ctxs]
    torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
    den = torch._foreach_sqrt(ms)
    torch._foreach_add_(den, ctxs[0].attr("epsilon", 1e-6))
    step = torch._foreach_mul(gs, _lrs(ctxs))
    torch._foreach_div_(step, den)
    torch._foreach_sub_(ps, step)
    return [{"ParamOut": p, "MomentOut": m} for p, m in zip(ps, ms)]


def adamax_group(ctxs):
    """``Moment = β1·Moment + (1 − β1)·g``, ``InfNorm = max(β2·InfNorm,
    |g|)``, ``Param −= (lr / (1 − β1ᵗ))·Moment / (InfNorm + ε)``; the
    ``Beta1Pow`` advances in the ``scale`` op the optimizer appends."""
    c0 = ctxs[0]
    b1, b2 = c0.attr("beta1", 0.9), c0.attr("beta2", 0.999)
    ps, ms, infs = _col(ctxs, "Param"), _col(ctxs, "Moment"), \
        _col(ctxs, "InfNorm")
    gs = [_grad(c) for c in ctxs]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
    torch._foreach_mul_(infs, b2)
    torch._foreach_maximum_(infs, torch._foreach_abs(gs))
    den1 = torch._foreach_neg([c.input("Beta1Pow").reshape(1) for c in ctxs])
    torch._foreach_add_(den1, 1.0)
    step = torch._foreach_mul(ms, torch._foreach_div(_lrs(ctxs), den1))
    den = torch._foreach_add(infs, c0.attr("epsilon", 1e-8))
    torch._foreach_div_(step, den)
    torch._foreach_sub_(ps, step)
    return [{"ParamOut": p, "MomentOut": m, "InfNormOut": i}
            for p, m, i in zip(ps, ms, infs)]


def decayed_adagrad_group(ctxs):
    """``Moment = decay·Moment + (1 − decay)·g·g``, ``Param −= lr·g /
    (√Moment + ε)``."""
    ps, ms, gs = _col(ctxs, "Param"), _col(ctxs, "Moment"), \
        [_grad(c) for c in ctxs]
    _decay_into(ms, ctxs[0].attr("decay", 0.95), gs, gs)
    den = torch._foreach_sqrt(ms)
    torch._foreach_add_(den, ctxs[0].attr("epsilon", 1e-6))
    step = torch._foreach_mul(gs, _lrs(ctxs))
    torch._foreach_div_(step, den)
    torch._foreach_sub_(ps, step)
    return [{"ParamOut": p, "MomentOut": m} for p, m in zip(ps, ms)]


def adadelta_group(ctxs):
    """``E[g²] = ρ·E[g²] + (1 − ρ)·g·g``, ``u = −√((E[u²] + ε) / (E[g²] +
    ε))·g``, ``E[u²] = ρ·E[u²] + (1 − ρ)·u·u``, ``Param += u`` (no
    learning rate, as the reference)."""
    c0 = ctxs[0]
    rho, eps = c0.attr("rho", 0.95), c0.attr("epsilon", 1e-6)
    ps = _col(ctxs, "Param")
    asgs, asus = _col(ctxs, "AvgSquaredGrad"), _col(ctxs, "AvgSquaredUpdate")
    gs = [_grad(c) for c in ctxs]
    _decay_into(asgs, rho, gs, gs)
    upd = torch._foreach_add(asus, eps)
    torch._foreach_div_(upd, torch._foreach_add(asgs, eps))
    torch._foreach_sqrt_(upd)
    torch._foreach_neg_(upd)
    torch._foreach_mul_(upd, gs)
    _decay_into(asus, rho, upd, upd)
    torch._foreach_add_(ps, upd)
    return [{"ParamOut": p, "AvgSquaredGradOut": a, "AvgSquaredUpdateOut": u}
            for p, a, u in zip(ps, asgs, asus)]


def ftrl_group(ctxs):
    """FTRL-proximal: with ``n' = n + g·g`` and ``σ = (n'^(−lr_power) −
    n^(−lr_power)) / lr`` (square roots at ``lr_power`` −0.5), ``z += g −
    σ·Param`` and ``Param = (l1·sign(z) − z) / (n'^(−lr_power)/lr + 2·l2)``
    where ``|z| > l1``, else 0."""
    c0 = ctxs[0]
    l1, l2 = c0.attr("l1", 0.0), c0.attr("l2", 0.0)
    lr_power = c0.attr("lr_power", -0.5)
    ps, sqs, lins = _col(ctxs, "Param"), _col(ctxs, "SquaredAccumulator"), \
        _col(ctxs, "LinearAccumulator")
    gs, lrs = [_grad(c) for c in ctxs], _lrs(ctxs)
    new_sq = torch._foreach_add(sqs, torch._foreach_mul(gs, gs))
    if lr_power == -0.5:
        root_new, root_old = torch._foreach_sqrt(new_sq), torch._foreach_sqrt(sqs)
    else:
        root_new = torch._foreach_pow(new_sq, -lr_power)
        root_old = torch._foreach_pow(sqs, -lr_power)
    sigma = torch._foreach_sub(root_new, root_old)
    torch._foreach_div_(sigma, lrs)
    torch._foreach_add_(lins, gs)
    torch._foreach_sub_(lins, torch._foreach_mul(sigma, ps))
    den = torch._foreach_div(root_new, lrs)
    torch._foreach_add_(den, 2.0 * l2)
    x = torch._foreach_sign(lins)
    torch._foreach_mul_(x, l1)
    torch._foreach_sub_(x, lins)
    torch._foreach_div_(x, den)
    for p, lin, xi in zip(ps, lins, x):
        p.copy_(torch.where(lin.abs() > l1, xi, 0.0))
    torch._foreach_copy_(sqs, new_sq)
    return [{"ParamOut": p, "SquaredAccumOut": s, "LinearAccumOut": z}
            for p, s, z in zip(ps, sqs, lins)]


def proximal_gd_group(ctxs):
    """``prox = Param − lr·g``, then the proximal operator
    (:func:`_prox_into`)."""
    c0 = ctxs[0]
    ps, gs = _col(ctxs, "Param"), _dense_only(ctxs)
    lrs = [lr.to(p.dtype) for lr, p in zip(_lrs(ctxs), ps)]
    prox = torch._foreach_sub(ps, torch._foreach_mul(gs, lrs))
    _prox_into(ps, prox, lrs, c0.attr("l1", 0.0), c0.attr("l2", 0.0))
    return [{"ParamOut": p} for p in ps]


def proximal_adagrad_group(ctxs):
    """``Moment += g·g``, ``prox = Param − lr·g / √(Moment + 1e-10)``, then
    the proximal operator with the scalar lr (:func:`_prox_into`)."""
    c0 = ctxs[0]
    ps, ms, gs = _col(ctxs, "Param"), _col(ctxs, "Moment"), \
        _dense_only(ctxs)
    lrs = [lr.to(p.dtype) for lr, p in zip(_lrs(ctxs), ps)]
    torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
    den = torch._foreach_add(ms, 1e-10)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(gs, lrs)
    torch._foreach_div_(step, den)
    prox = torch._foreach_sub(ps, step)
    _prox_into(ps, prox, lrs, c0.attr("l1", 0.0), c0.attr("l2", 0.0))
    return [{"ParamOut": p, "MomentOut": m} for p, m in zip(ps, ms)]


_K_MAX_ACCUMULATES = 16384  # the reference's kMaxNumAccumulates


def average_accumulates_group(ctxs):
    """``ModelAverage``'s running sums, on the device with no host read
    (a window captures it).  Per op: ``sum_1 += param`` and the counters
    advance; every 16,384 updates ``sum_1`` folds into ``sum_2``; when
    ``num_accumulates ≥ min_average_window`` and ``≥ min(max_average_
    window, average_window · num_updates)`` the window closes: ``sum_3 =
    sum_1 + sum_2``, both zeroed, ``old_num_accumulates = num_
    accumulates``, which restarts at 0.

    The window test is in float64, as the reference's (it runs with x64):
    in float32 ``0.15 · 100`` is 15.000000954 and ``15 ≥`` it fails where
    the reference closes the window.  The counters of the whole run are
    tested at once; the sums take ``torch.where`` per op.  ``sum_1 +
    sum_2`` after a fold is ``0 + (sum_2 + sum_1)``, equal to ``sum_2 +
    sum_1`` for every sum that starts at +0, so it is added once."""
    c0 = ctxs[0]
    window = float(c0.attr("average_window", 0.0))
    max_w = float(c0.attr("max_average_window", 10000))
    min_w = c0.attr("min_average_window", 10000)
    params = _col(ctxs, "param")
    s1s, s2s, s3s = (_col(ctxs, f"in_sum_{i}") for i in (1, 2, 3))
    nas, onas, nus = (_col(ctxs, f"in_{n}") for n in (
        "num_accumulates", "old_num_accumulates", "num_updates"))
    na = torch.cat([t.reshape(1) for t in nas]) + 1
    nu = torch.cat([t.reshape(1) for t in nus]) + 1
    ona = torch.cat([t.reshape(1) for t in onas])
    fold = nu % _K_MAX_ACCUMULATES == 0
    trig = (na >= min_w) & (na.double() >= (nu.double() * window)
                            .clamp(max=max_w))
    ona = torch.where(trig, na, ona)
    na = na.masked_fill(trig, 0)
    torch._foreach_add_(s1s, params)
    both = torch._foreach_add(s2s, s1s)
    zero_1 = fold | trig
    for k, (s1, s2, s3, s12) in enumerate(zip(s1s, s2s, s3s, both)):
        torch.where(trig[k], s12, s3, out=s3)
        torch.where(fold[k], s12, s2, out=s2)
        s2.masked_fill_(trig[k], 0)
        s1.masked_fill_(zero_1[k], 0)
    for col, new in ((nas, na), (onas, ona), (nus, nu)):
        torch._foreach_copy_(col, [v.reshape(t.shape) for v, t in
                                 zip(new.to(col[0].dtype).split(1), col)])
    return [{"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
             "out_num_accumulates": a, "out_old_num_accumulates": o,
             "out_num_updates": u}
            for s1, s2, s3, a, o, u in zip(s1s, s2s, s3s, nas, onas, nus)]


for _type, _group, _no_grad in (
        ("adagrad", adagrad_group,
         ("Param", "Grad", "Moment", "LearningRate")),
        ("adamax", adamax_group,
         ("Param", "Grad", "LearningRate", "Moment", "InfNorm", "Beta1Pow")),
        ("adadelta", adadelta_group,
         ("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate")),
        ("decayed_adagrad", decayed_adagrad_group,
         ("Param", "Grad", "Moment", "LearningRate")),
        ("ftrl", ftrl_group,
         ("Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
          "LearningRate")),
        ("proximal_gd", proximal_gd_group,
         ("Param", "Grad", "LearningRate")),
        ("proximal_adagrad", proximal_adagrad_group,
         ("Param", "Grad", "Moment", "LearningRate")),
        ("average_accumulates", average_accumulates_group,
         ("param", "in_sum_1", "in_sum_2", "in_sum_3", "in_num_accumulates",
          "in_old_num_accumulates", "in_num_updates"))):
    register_op(_type, no_grad_inputs=_no_grad)(_single(_group))
    register_group(_type)(_group)
