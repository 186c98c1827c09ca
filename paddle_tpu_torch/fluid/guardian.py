"""The dynamic loss scaler's part of the training guardian (counterpart of
``paddle_tpu/fluid/guardian.py``): the per-program guard spec, the
backward-seed multiplier, the finite flag, and the commit gate with the
loss-scale update of ``fold_health``.

A program built by ``Optimizer.minimize`` while ``fluid.amp`` dynamic loss
scaling is active (fp16 by default) carries the scale vars
(``amp.LOSS_SCALE_VAR``, ``amp.LOSS_SCALE_GOOD_VAR``).  The Executor runs
such a program guarded:

 - the ``__loss_seed__`` op's output is multiplied by the scale
   (:func:`seed_multiplier`), so the fp16 grads of the backward sit in
   range; the unscale ops divide the raw grads back before the update;
 - after the backward, before the first ``Optimize``-role op, it takes
   the flag "the loss and every raw grad are finite" (:func:`finite_flag`,
   a device tensor);
 - on overflow :func:`fold_health` commits the state the step started
   from for every read-write persistable (parameters, moments, beta pows,
   batch-norm running stats, the step counter), bitwise; the RNG and the
   scale vars still advance.  The scale halves (never below 1) and the
   good-step counter resets; otherwise the counter counts and the scale
   doubles every ``growth_interval`` good steps.

Two ways to gate, with bitwise the same result:

 - ``Executor.run`` reads the flag on the host (:func:`step_finite`, one
   device synchronization a step) and on overflow skips the ``Optimize``
   ops;
 - an ``Executor.run_steps`` window reads nothing on the host: the
   ``Optimize`` ops always run, the read-write persistables they update in
   place are snapshot before the first of them, and :func:`fold_health`,
   given the device flag, commits ``torch.where(finite, new, old)`` and
   updates the scale on the device.

The reference folds the check and the commit into its jitted step, as the
window does.

The ``Guardian`` itself (policies, the loss-spike cap, the flight recorder,
``replay``) and the fault injection the reference folds into the seed are
not ported: :func:`enable` raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["GuardSpec", "for_program", "seed_multiplier", "finite_flag",
           "step_finite", "fold_health", "enable"]


class GuardSpec:
    """Static description of how to guard one training Program."""

    def __init__(self, loss_name: str, grad_names: List[str],
                 scale_vars, growth_interval: int):
        self.loss_name = loss_name
        self.grad_names = list(grad_names)
        self.scale_vars = tuple(scale_vars)
        self.growth_interval = int(growth_interval)

    def extra_fetch_names(self) -> List[str]:
        return [self.loss_name] + self.grad_names


def enable(policy: str = "skip", **kwargs):
    raise NotImplementedError(
        "the numerics guardian (policies, spike cap, flight recorder, "
        "replay) is not ported yet: ROADMAP.md queue 1 item 7; the dynamic "
        "loss scaler of fluid.amp runs without it")


def for_program(program) -> Optional[GuardSpec]:
    """GuardSpec when this program should run guarded: a training program
    (params/grads and a recorded loss) built with dynamic loss scaling
    (the reference also guards every program while a Guardian is armed;
    the port has none)."""
    if getattr(program, "_params_grads", None) is None:
        return None
    loss_name = getattr(program, "_loss_name", None)
    if not loss_name:
        return None
    scale_vars = getattr(program, "_loss_scale_vars", None)
    if scale_vars is None:
        return None
    grad_names = [g.name for _, g in program._params_grads if g is not None]
    if not grad_names:
        return None
    return GuardSpec(loss_name, grad_names, scale_vars,
                     getattr(program, "_loss_scale_growth", 1000))


def seed_multiplier(spec: GuardSpec, state: Dict):
    """The fp32 scalar the backward seed is multiplied by: the dynamic loss
    scale (the reference multiplies in its fault injection too, which the
    port does not carry)."""
    return state[spec.scale_vars[0]].reshape(()).float()


def finite_flag(loss, grads) -> torch.Tensor:
    """A 0-d bool device tensor: the loss and every raw grad are finite."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads if g.numel()]
    return torch.stack(flags).all()


def step_finite(loss, grads) -> bool:
    """:func:`finite_flag` read on the host: one device synchronization."""
    return bool(finite_flag(loss, grads))


def fold_health(spec: GuardSpec, finite, new_state: Dict, mut_state: Dict,
                state: Dict):
    """The commit gate and the loss-scale update.  ``finite``: a bool, or
    the device flag of :func:`finite_flag` (then every choice is a
    ``torch.where`` on the device, with the same values).  ``new_state``:
    the step's persistable outputs; ``mut_state``: the values the step
    started from for the read-write ones; ``state``: everything the step
    read (the scale vars among it).  Returns the state to commit: on a
    non-finite step every read-write var but the RNG state and the scale
    vars keeps its old value; the scale vars are updated.  (The reference
    also returns the step's health for its Guardian.)"""
    from .framework import RNG_STATE_VAR

    on_device = isinstance(finite, torch.Tensor)
    skip_revert = {RNG_STATE_VAR, *spec.scale_vars}
    committed = {}
    for name, val in new_state.items():
        old = mut_state.get(name)
        if old is None or name in skip_revert:
            committed[name] = val
        elif on_device:
            committed[name] = torch.where(finite, val, old)
        else:
            committed[name] = val if finite else old
    scale_name, good_name = spec.scale_vars
    s_old, g_old = state[scale_name], state[good_name]
    scale = s_old.reshape(()).float()
    good = g_old.reshape(()).to(torch.int32)
    up_good = good + 1
    grow = up_good >= spec.growth_interval
    up_scale = torch.where(grow, scale * 2.0, scale)
    up_good = torch.where(grow, torch.zeros_like(up_good), up_good)
    down_good = torch.zeros_like(good)
    down_scale = torch.clamp_min(scale * 0.5, 1.0)
    if on_device:
        new_scale = torch.where(finite, up_scale, down_scale)
        new_good = torch.where(finite, up_good, down_good)
    elif finite:
        new_scale, new_good = up_scale, up_good
    else:
        new_scale, new_good = down_scale, down_good
    committed[scale_name] = new_scale.reshape(s_old.shape).to(s_old.dtype)
    committed[good_name] = new_good.reshape(g_old.shape).to(g_old.dtype)
    return committed
