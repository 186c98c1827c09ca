"""Activation ops (counterpart of ``paddle_tpu/ops/activation_ops.py``):
relu, sigmoid, tanh and square (the ``act`` of fc / conv2d layers, the
SE gate, DeepFM's FM term), softmax, the unary ops the learning-rate
schedules emit (exp, floor, ceil, cos), log (the beam-search decoder's
step scores), and the rest of the reference's activations, each the
reference's expression.  Their grads come from the generic grad; a
bf16 / fp16 input stays in its dtype, as in the reference.

Where torch's own function parts from the reference's JAX one at a
point, the expression follows JAX's: a clip is ``minimum(maximum(x, lo),
hi)`` (a tie at a bound splits the grad in halves, as ``jnp.clip``'s;
``torch.clamp`` gives it whole), ``abs`` has grad 1 at 0, ``gelu`` is
the tanh form (``jax.nn.gelu``'s default), ``softplus`` is
``logaddexp(x, 0)`` (``F.softplus`` turns linear past 20), and
``leaky_relu`` / ``elu`` / ``prelu`` select ``x >= 0`` (grad 1 at 0)."""

from __future__ import annotations

import torch

from .registry import register_op


def _unary(name, fn):
    @register_op(name)
    def _impl(ctx, _fn=fn):
        return {"Out": _fn(ctx.input("X"))}
    return _impl


_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("square", torch.square)
_unary("exp", torch.exp)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("cos", torch.cos)
_unary("log", torch.log)


def _scalar(v, x):
    """An attr as the reference's JAX arithmetic meets ``x``: rounded to a
    bf16 / fp16 ``x``'s dtype first (a weakly typed scalar)."""
    from ..fluid import amp

    return amp.weak_scalar(v, x.dtype)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, a tie at a bound
    taking half the grad.  The bounds are filled on ``x``'s device in its
    dtype (no host copy, so a CUDA graph can capture it)."""
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def abs_(x):
    """``jnp.abs``, whose grad at 0 is 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


_unary("logsigmoid", lambda x: -_softplus(-x))
_unary("tanh_shrink", lambda x: x - torch.tanh(x))
_unary("abs", abs_)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary("reciprocal", lambda x: 1.0 / x)
# half to even, as jnp.round; its grad is 0 in both
_unary("round", torch.round)
_unary("sin", torch.sin)
_unary("softplus", _softplus)
_unary("softsign", lambda x: x / (abs_(x) + 1))
# the reference's lambda is a fixed 0.5 (it reads no attr)
_unary("softshrink", lambda x: torch.where(
    x > 0.5, x - 0.5, torch.where(x < -0.5, x + 0.5, torch.zeros_like(x))))
_unary("gelu", lambda x: torch.nn.functional.gelu(x, approximate="tanh"))


@register_op("relu6")
def relu6(ctx):
    return {"Out": clip(ctx.input("X"), 0.0, ctx.attr("threshold", 6.0))}


@register_op("leaky_relu")
def leaky_relu(ctx):
    x = ctx.input("X")
    return {"Out": torch.where(x >= 0, x,
                               _scalar(ctx.attr("alpha", 0.02), x) * x)}


@register_op("elu")
def elu(ctx):
    x = ctx.input("X")
    a = _scalar(ctx.attr("alpha", 1.0), x)
    return {"Out": torch.where(x >= 0, x, a * (torch.exp(x) - 1.0))}


@register_op("pow")
def pow_op(ctx):
    x = ctx.input("X")
    return {"Out": torch.pow(x, _scalar(ctx.attr("factor", 1.0), x))}


@register_op("stanh")
def stanh(ctx):
    x = ctx.input("X")
    a = _scalar(ctx.attr("scale_a", 0.67), x)
    b = _scalar(ctx.attr("scale_b", 1.7159), x)
    return {"Out": b * torch.tanh(a * x)}


@register_op("hard_sigmoid")
def hard_sigmoid(ctx):
    x = ctx.input("X")
    slope = _scalar(ctx.attr("slope", 0.2), x)
    offset = _scalar(ctx.attr("offset", 0.5), x)
    return {"Out": clip(slope * x + offset, 0.0, 1.0)}


@register_op("hard_shrink")
def hard_shrink(ctx):
    x = ctx.input("X")
    return {"Out": torch.where(abs_(x) > ctx.attr("threshold", 0.5), x,
                               torch.zeros_like(x))}


@register_op("thresholded_relu")
def thresholded_relu(ctx):
    x = ctx.input("X")
    return {"Out": torch.where(x > ctx.attr("threshold", 1.0), x,
                               torch.zeros_like(x))}


@register_op("soft_relu")
def soft_relu(ctx):
    """``log(1 + exp(clip(x, -t, t)))``, the reference's expression."""
    t = ctx.attr("threshold", 40.0)
    return {"Out": torch.log(1.0 + torch.exp(clip(ctx.input("X"), -t, t)))}


@register_op("brelu")
def brelu(ctx):
    return {"Out": clip(ctx.input("X"), ctx.attr("t_min", 0.0),
                        ctx.attr("t_max", 24.0))}


@register_op("swish")
def swish(ctx):
    x = ctx.input("X")
    return {"Out": x * torch.sigmoid(_scalar(ctx.attr("beta", 1.0), x) * x)}


@register_op("prelu")
def prelu(ctx):
    """``Alpha`` one value (``all``), one a channel (dim 1, ``channel``) or
    one an element of a row (``element``)."""
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        raise ValueError(f"prelu: mode {mode!r} is not all, channel or "
                         f"element")
    return {"Out": torch.where(x >= 0, x, a * x)}


@register_op("softmax")
def softmax(ctx):
    """A bf16 / fp16 input is exponentiated and renormalized in fp32 (low
    exponentials lose the tail mass) and the result cast back, so
    attention maps stay low under AMP keep_activations."""
    from ..fluid import amp

    x = ctx.input("X")
    if amp.is_low_float(x.dtype):
        return {"Out": torch.softmax(x.float(), dim=-1).to(x.dtype)}
    return {"Out": torch.softmax(x, dim=-1)}


@register_op("log_softmax")
def log_softmax(ctx):
    return {"Out": torch.log_softmax(ctx.input("X"),
                                     dim=ctx.attr("axis", -1))}
