"""Adaptive speculation controller (counterpart of
``paddle_tpu/serving/specdec/controller.py``): rolling acceptance-rate
gauges and the fallback / re-arm state machine.

A spec tick costs k + 1 draft dispatches plus one (k + 1)-position
verify, so at low acceptance it is worse than the plain tick it replaced.
The controller watches a rolling window of spec ticks:

 - every spec tick reports ``(accepted, drafted)`` per participating slot;
   the aggregate over the window feeds the ``spec_accept_rate`` gauge;
 - once the window is FULL and the aggregate rate sits below
   ``min_accept``, the controller trips: the engine runs plain one-token
   ticks and ``spec_fallbacks`` counts it;
 - after ``window`` plain ticks of cooldown it re-arms with a cleared
   window, so a transient collapse (the draft-poison drill ending)
   recovers without a restart.

Tripping never changes output bits (acceptance keeps only target
argmaxes); it only stops spending draft work.  Callers hold the engine's
dispatch lock; no internal locking.  The reference also mirrors the rate
and the fallback / re-arm events into a process-wide observability
registry, which the port does not have yet."""

from __future__ import annotations

import collections
from typing import Deque, Dict, Optional, Tuple

__all__ = ["SpecController"]


class SpecController:

    def __init__(self, min_accept: float, window: int, metrics=None):
        self.min_accept = float(min_accept)
        self.window = max(1, int(window))
        self._metrics = metrics
        self._samples: Deque[Tuple[int, int]] = \
            collections.deque(maxlen=self.window)
        self._slot_samples: Dict[int, Deque[Tuple[int, int]]] = {}
        self._fallen = False
        self._cooldown = 0
        self.fallbacks = 0

    # -- state -------------------------------------------------------------

    @property
    def armed(self) -> bool:
        """True = the next tick may speculate."""
        return not self._fallen

    def rate(self) -> Optional[float]:
        """Aggregate accepted/drafted over the rolling window (None until
        the first spec tick lands)."""
        drafted = sum(d for _a, d in self._samples)
        if not drafted:
            return None
        return sum(a for a, _d in self._samples) / drafted

    def slot_rate(self, slot: int) -> Optional[float]:
        """One slot's rolling acceptance rate (None = never speculated)."""
        q = self._slot_samples.get(slot)
        if not q:
            return None
        drafted = sum(d for _a, d in q)
        return (sum(a for a, _d in q) / drafted) if drafted else None

    # -- transitions -------------------------------------------------------

    def observe(self, per_slot: Dict[int, Tuple[int, int]]) -> None:
        """Record one spec tick's ``{slot: (accepted, drafted)}`` and trip
        to fallback if the full window runs below the floor."""
        acc = sum(a for a, _d in per_slot.values())
        drafted = sum(d for _a, d in per_slot.values())
        self._samples.append((acc, drafted))
        for slot, sample in per_slot.items():
            q = self._slot_samples.get(slot)
            if q is None:
                q = self._slot_samples[slot] = \
                    collections.deque(maxlen=self.window)
            q.append(sample)
        rate = self.rate()
        if rate is not None and self._metrics is not None:
            self._metrics.set_gauge("spec_accept_rate", round(rate, 6))
        if (rate is not None and rate < self.min_accept
                and len(self._samples) == self.window):
            self._fallen = True
            self._cooldown = self.window
            self.fallbacks += 1
            if self._metrics is not None:
                self._metrics.inc("spec_fallbacks")

    def note_plain_tick(self) -> None:
        """One plain tick elapsed while fallen; re-arm at cooldown 0.  The
        window clears so stale samples cannot trip the next spec tick."""
        if not self._fallen:
            return
        self._cooldown -= 1
        if self._cooldown <= 0:
            self._fallen = False
            self._samples.clear()
            for q in self._slot_samples.values():
                q.clear()

    def retire_slot(self, slot: int) -> None:
        """Drop a retired slot's rolling state: the next resident of the
        slot id starts with a fresh rate."""
        self._slot_samples.pop(slot, None)
