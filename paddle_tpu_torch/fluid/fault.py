"""Deterministic fault injection (counterpart of
``paddle_tpu/fluid/fault.py``), in part: the speculative-draft poison that
the serving slice consults, and the two storage faults ``fluid.io``
consults around every checkpoint file it reads or writes.

A plan is armed programmatically (``install(FaultPlan(...))``) or from the
environment, read through ``fluid.envcontract`` the first time
:func:`active` is asked:

    PADDLE_FAULT_SPEC_DRAFT_POISON=n  from engine tick n on, every token
                                  the speculative draft proposes is
                                  replaced with deterministic garbage:
                                  acceptance collapses, the spec
                                  controller must fall back, and every
                                  emitted stream stays bitwise correct
    PADDLE_FAULT_IO_DELAY_MS=ms   sleep before every checkpoint write
    PADDLE_FAULT_IO_ERROR_RATE=f  the first attempt at a seeded fraction f
                                  of checkpoint (path, op) keys raises
                                  OSError; ``fluid.retry`` must recover
    PADDLE_FAULT_IO_ERROR_SEED=s  the seed of that choice

The reference's other faults (kills, checkpoint crashes, stalls, leaks,
NaN faults) and the rank restriction are not ported yet.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

__all__ = ["FaultPlan", "install", "clear", "active", "spec_draft_poison",
           "io_delay", "io_error"]

_ENV_FIELDS = {
    "spec_draft_poison": "PADDLE_FAULT_SPEC_DRAFT_POISON",
    "io_delay_ms": "PADDLE_FAULT_IO_DELAY_MS",
    "io_error_rate": "PADDLE_FAULT_IO_ERROR_RATE",
    "io_error_seed": "PADDLE_FAULT_IO_ERROR_SEED",
}


class FaultPlan:
    """One armed fault scenario; ``None`` (or 0) disarms a fault."""

    def __init__(self, spec_draft_poison: Optional[int] = None,
                 io_delay_ms: float = 0.0, io_error_rate: float = 0.0,
                 io_error_seed: int = 0):
        self.spec_draft_poison = None if spec_draft_poison is None \
            else int(spec_draft_poison)
        self.io_delay_ms = float(io_delay_ms)
        self.io_error_rate = float(io_error_rate)
        self.io_error_seed = int(io_error_seed)
        # (path tail, op) -> attempts seen by io_error
        self._io_error_attempts: dict = {}

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """The ``PADDLE_FAULT_*`` knobs of ``env`` (default: the process
        environment) as a plan; None when nothing is armed."""
        from . import envcontract as _ec

        env = os.environ if env is None else env
        vals = {field: _ec.REGISTRY[name].parse(env.get(name))
                for field, name in _ENV_FIELDS.items()}
        if vals["spec_draft_poison"] is None and not vals["io_delay_ms"] \
                and not vals["io_error_rate"]:
            return None
        return cls(**vals)


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


def io_delay() -> None:
    """Slow-storage simulation: sleep inside checkpoint write paths."""
    plan = active()
    if plan is not None and plan.io_delay_ms > 0:
        time.sleep(plan.io_delay_ms / 1000.0)


def _io_error_key(path: str) -> str:
    """A file's identity across runs: the path's last two components (the
    enclosing temporary directory differs per run, the tail does not)."""
    parts = [p for p in os.path.normpath(path).split(os.sep) if p]
    return "/".join(parts[-2:])


def io_error(path: str, op: str) -> None:
    """Transient-I/O oracle, consulted right before each raw read or write
    of a checkpoint file: a seeded hash of ``(seed, path tail, op)`` picks
    the fraction ``io_error_rate`` of keys that fail; a picked key's FIRST
    attempt raises OSError and every later attempt succeeds, so bounded
    retry (``fluid.retry.retry_io``) always recovers.  The same hash as
    the reference's: one seed fails the same files in both packages."""
    plan = active()
    if plan is None or plan.io_error_rate <= 0:
        return
    key = (_io_error_key(path), str(op))
    digest = hashlib.sha1(
        f"{plan.io_error_seed}|{key[0]}|{key[1]}".encode()).hexdigest()
    if int(digest[:8], 16) / float(0xFFFFFFFF) >= plan.io_error_rate:
        return
    attempts = plan._io_error_attempts.get(key, 0)
    plan._io_error_attempts[key] = attempts + 1
    if attempts == 0:
        raise OSError(
            f"injected transient I/O error ({key[1]} {key[0]}, "
            f"attempt 1 — retry succeeds)")
