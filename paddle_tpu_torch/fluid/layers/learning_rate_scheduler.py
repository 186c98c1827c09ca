"""Learning-rate schedules (counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``): noam,
exponential, natural_exp, inverse_time, polynomial, piecewise and cosine
decay.

Each schedule is a few ops of the main program over the auto-incremented
step counter (``@STEP_COUNTER@``, int64, 1 at the first run), so the
learning rate advances with the step on the device: an
``Executor.run_steps`` window replays them with the rest of the step.
``append_LARS`` (the Optimizer's ``LARS_weight_decay``) gives each
parameter a learning rate computed every step from its norm and its
grad's."""

from __future__ import annotations

import math

from . import ops as _ops
from .nn import autoincreased_step_counter, elementwise_min
from .tensor import cast, fill_constant

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "append_LARS"]


def _global_step():
    counter = autoincreased_step_counter(begin=1)
    return cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    global_step = _global_step()
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _global_step()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = _ops.floor(div_res)
    return learning_rate * (float(decay_rate) ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _global_step()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = _ops.floor(div_res)
    return learning_rate * _ops.exp(div_res * float(-decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _global_step()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = _ops.floor(div_res)
    return learning_rate / (div_res * float(decay_rate) + 1.0)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _global_step()
    if cycle:
        div_res = _ops.ceil(global_step / float(decay_steps))
        decay_steps_var = div_res * float(decay_steps)
        p = global_step / decay_steps_var
    else:
        p = elementwise_min(global_step / float(decay_steps),
                            fill_constant([1], "float32", 1.0))
    return (learning_rate - end_learning_rate) * ((1.0 - p) ** power) \
        + end_learning_rate


def piecewise_decay(boundaries, values):
    """``values[i]`` for a step in ``(boundaries[i-1], boundaries[i]]``,
    ``values[-1]`` past the last boundary.  Branch-free: the sum of the
    constants masked by the step's interval."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _global_step()
    lr = fill_constant([1], "float32", values[-1])
    prev_bound = None
    for i, b in enumerate(boundaries):
        below = cast(global_step <= float(b), "float32")
        if prev_bound is not None:
            above = cast(global_step > float(prev_bound), "float32")
            mask = below * above
        else:
            mask = below
        lr = lr + mask * (values[i] - values[-1])
        prev_bound = b
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _global_step()
    cur_epoch = _ops.floor(global_step / float(step_each_epoch))
    return learning_rate * 0.5 * (
        _ops.cos(cur_epoch * (math.pi / float(epochs))) + 1.0)


def append_LARS(params_grads, learning_rate, weight_decay):
    """LARS, layer-wise adaptive rate scaling: per parameter, ``lr =
    learning_rate · ‖param‖ / (‖grad‖ + weight_decay · ‖param‖)``, the
    ops ``square``, ``reduce_sum``, ``sqrt``, ``scale`` and
    ``elementwise_{mul,div,add}`` appended to the current program.  The
    result becomes the parameter's ``optimize_attr["learning_rate"]``,
    which ``Optimizer._create_param_lr`` hands to the update op; a
    parameter's own rate (a number or a Variable) multiplies in."""
    from . import nn as _nn

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return _nn.elementwise_add(grad_norm, param_norm)
        return _nn.elementwise_add(
            grad_norm, _nn.scale(param_norm, scale=float(weight_decay)))

    for param, grad in params_grads:
        if grad is None:
            continue
        attr = param.optimize_attr or {}
        param_lr = attr.get("learning_rate", 1.0)
        param_norm = _ops.sqrt(_nn.reduce_sum(_ops.square(param)))
        grad_norm = _ops.sqrt(_nn.reduce_sum(_ops.square(grad)))
        if isinstance(param_lr, (int, float)):
            scaled = learning_rate if param_lr == 1.0 else \
                _nn.scale(learning_rate, scale=float(param_lr))
        else:  # a Variable (a rate of its own, or an earlier LARS pass)
            scaled = _nn.elementwise_mul(learning_rate, param_lr)
        decayed = _nn.elementwise_div(
            _nn.elementwise_mul(scaled, param_norm),
            _balanced_weight(param_norm, grad_norm))
        attr["learning_rate"] = decayed
        param.optimize_attr = attr
