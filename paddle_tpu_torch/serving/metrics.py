"""Serving metrics for one engine (counterpart of
``paddle_tpu/serving/metrics.py``): counters, gauges and the request,
time-to-first-token and inter-token latency series, read through
:meth:`ServingMetrics.snapshot`.

Self-contained: the reference also mirrors every value into a
process-wide observability registry, an SLO watchdog and the profiler;
those come with a later slice of the port.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """Thread-safe counters, gauges and latency ring buffers."""

    #: counters every snapshot reports even when still zero
    COUNTERS = ("submitted", "completed", "failed", "shed", "expired",
                "warmup_dispatches", "prefills", "decode_ticks",
                "tokens_generated", "prefix_hits", "prefill_skips",
                "page_requeues")

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self._gauges: Dict[str, float] = {"queue_depth": 0}
        # ring buffers, seconds: percentiles stay bounded-memory under load
        self._window = int(latency_window)
        self._series: Dict[str, List[float]] = {
            "latency": [], "ttft": [], "intertoken": []}
        self._seen: Dict[str, int] = {k: 0 for k in self._series}
        self._t0 = time.perf_counter()

    # -- recording --
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def _observe(self, series: str, seconds: float) -> None:
        with self._lock:
            buf = self._series[series]
            n = self._seen[series]
            if len(buf) < self._window:
                buf.append(float(seconds))
            else:
                buf[n % self._window] = float(seconds)
            self._seen[series] = n + 1

    def observe_latency(self, seconds: float) -> None:
        """One completed request's submit-to-last-token latency."""
        self._observe("latency", seconds)

    def observe_ttft(self, seconds: float) -> None:
        """Time to first token of one request: queueing + prefill + the
        first decode tick."""
        self._observe("ttft", seconds)

    def observe_intertoken(self, seconds: float) -> None:
        """Gap between two consecutive generated tokens of one stream."""
        self._observe("intertoken", seconds)

    def note_slots(self, active: int, free: int) -> None:
        self.set_gauge("slots_active", int(active))
        self.set_gauge("slots_free", int(free))

    # -- reading --
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    @staticmethod
    def _percentiles(samples, qs, prefix):
        if not samples:
            return {f"{prefix}p{int(q * 100)}_ms": None for q in qs}
        s = sorted(samples)
        return {f"{prefix}p{int(q * 100)}_ms":
                s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]
                * 1e3 for q in qs}

    def snapshot(self) -> dict:
        """Point-in-time dict of every metric (safe to json.dump)."""
        with self._lock:
            snap = dict(self._counters)
            snap.update(self._gauges)
            series = {k: list(v) for k, v in self._series.items()}
            elapsed = time.perf_counter() - self._t0
        snap["elapsed_s"] = elapsed
        snap["qps"] = snap["completed"] / elapsed if elapsed > 0 else 0.0
        snap.update(self._percentiles(series["latency"], (0.50, 0.95, 0.99),
                                      ""))
        snap.update(self._percentiles(series["ttft"], (0.50, 0.99),
                                      "ttft_"))
        snap.update(self._percentiles(series["intertoken"], (0.50, 0.99),
                                      "intertoken_"))
        for k, v in series.items():
            snap[f"{k}_samples"] = len(v)
        return snap
