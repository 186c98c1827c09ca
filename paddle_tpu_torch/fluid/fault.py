"""Deterministic fault injection (counterpart of
``paddle_tpu/fluid/fault.py``), first part: the speculative-draft poison
that the serving slice consults.

A plan is armed programmatically (``install(FaultPlan(...))``) or from the
environment, read through ``fluid.envcontract`` the first time
:func:`active` is asked:

    PADDLE_FAULT_SPEC_DRAFT_POISON=n  from engine tick n on, every token
                                  the speculative draft proposes is
                                  replaced with deterministic garbage:
                                  acceptance collapses, the spec
                                  controller must fall back, and every
                                  emitted stream stays bitwise correct

The reference's other faults (kills, checkpoint crashes, stalls, leaks,
NaN and I/O faults) are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["FaultPlan", "install", "clear", "active", "spec_draft_poison"]


class FaultPlan:
    """One armed fault scenario; ``None`` disarms a fault."""

    def __init__(self, spec_draft_poison: Optional[int] = None):
        self.spec_draft_poison = None if spec_draft_poison is None \
            else int(spec_draft_poison)

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """The ``PADDLE_FAULT_*`` knobs of ``env`` (default: the process
        environment) as a plan; None when nothing is armed."""
        from . import envcontract as _ec

        env = os.environ if env is None else env
        poison = _ec.REGISTRY["PADDLE_FAULT_SPEC_DRAFT_POISON"].parse(
            env.get("PADDLE_FAULT_SPEC_DRAFT_POISON"))
        if poison is None:
            return None
        return cls(spec_draft_poison=poison)


# the armed plan: None = nothing armed; _UNSET = the environment not read
# yet, so a process that sets PADDLE_FAULT_* before first use is honoured
_UNSET = object()
_plan = _UNSET


def install(plan: Optional[FaultPlan]) -> None:
    """Arm a plan programmatically (overrides the environment)."""
    global _plan
    _plan = plan


def clear() -> None:
    """Disarm everything, including a plan read from the environment."""
    install(None)


def active() -> Optional[FaultPlan]:
    global _plan
    if _plan is _UNSET:
        _plan = FaultPlan.from_env()
    return _plan


def spec_draft_poison() -> Optional[int]:
    """The engine tick from which the speculative draft is poisoned, or
    None when disarmed (``serving/specdec`` asks once a spec tick)."""
    plan = active()
    return None if plan is None else plan.spec_draft_poison
