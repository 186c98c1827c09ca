"""The kernel wrappers' launch counters read and advanced as one table.

Each wrapper adds one to its module's counter where it launches its kernel
(``fused.adam_launches``, ``flash_attention.flash_fwd_launches_by_dtype``,
``paged_attention.launches``, ...), and each collective of a
data-parallel step to its own (``collectives.all_reduce_launches``, ...).  A CUDA graph captures a wrapper's
launch once and replays it without calling the wrapper, so a graph runner
takes what one capture added (:func:`snapshot` before and after,
:func:`delta`), takes it back (the capture launched nothing) and adds it
once per replay (:func:`add`)."""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

_MODULES = ("fused", "flash_attention", "paged_attention", "collectives")

Key = Tuple[str, str, Optional[str]]


def _module(name):
    return sys.modules.get(f"{__package__}.{name}")


def snapshot() -> Dict[Key, int]:
    """Every counter: ``(module, name, None)`` for an int counter (names
    ``launches``, ``*_launches``, ``*_tensors``), ``(module, name, key)``
    for each entry of a ``*_launches_by_dtype``, ``*_launches_by_layout``
    or ``*_launches_by_axis`` dict.  A module that was never imported launched nothing and is left
    out."""
    out: Dict[Key, int] = {}
    for m in _MODULES:
        mod = _module(m)
        if mod is None:
            continue
        for name, v in vars(mod).items():
            if isinstance(v, dict) and name.endswith(
                    ("_launches_by_dtype", "_launches_by_layout",
                     "_launches_by_axis")):
                out.update(((m, name, k), c) for k, c in v.items())
            elif (type(v) is int and (name == "launches" or name.endswith(
                    ("_launches", "_tensors")))):
                out[(m, name, None)] = v
    return out


def delta(before: Dict[Key, int], after: Dict[Key, int]) -> Dict[Key, int]:
    """What changed from ``before`` to ``after``, counter by counter."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(change: Dict[Key, int], times: int = 1) -> None:
    """Add ``change`` to the counters ``times`` times (negative takes it
    back)."""
    for (m, name, k), d in change.items():
        mod = _module(m)
        if k is None:
            setattr(mod, name, getattr(mod, name) + d * times)
        else:
            getattr(mod, name)[k] += d * times
