"""Serving errors and the in-flight request record (counterpart of the
first half of ``paddle_tpu/serving/engine.py``).  The batch
``ServingEngine`` itself comes with a later slice of the port."""

from __future__ import annotations

from typing import Sequence

__all__ = ["EngineOverloaded", "RequestTimeout", "EngineClosed",
           "DrainTimeout"]


class EngineOverloaded(RuntimeError):
    """Bounded queue is full: the request was shed at admission."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired, in the queue or mid-generation."""


class EngineClosed(RuntimeError):
    """submit() after drain()/shutdown() began."""


class DrainTimeout(TimeoutError):
    """A bounded ``drain()``/``shutdown()`` expired with requests still
    outstanding; ``request_ids`` names them."""

    def __init__(self, message: str, request_ids: Sequence[str] = ()):
        super().__init__(message)
        self.request_ids = list(request_ids)


class _Request:
    """One in-flight decode request: the prompt and generated ids, the
    KV-cache ``slot`` and next write ``pos``ition, the page grant in paged
    mode, and the timing for TTFT, inter-token latency and the per-token
    deadline."""

    __slots__ = ("future", "deadline", "t_submit", "rid", "prompt",
                 "max_new", "pos", "out_tokens", "t_prev_token", "grant")

    def __init__(self, future, deadline, t_submit):
        self.future = future
        self.deadline = deadline  # absolute perf_counter time or None
        self.t_submit = t_submit
        self.rid = None           # engine-assigned request id
        self.prompt = None        # list[int] prompt token ids
        self.max_new = 0          # generation budget
        self.pos = 0              # next cache write position
        self.out_tokens = None    # generated ids, grown per tick
        self.t_prev_token = None  # previous token's perf time
        self.grant = None         # kvpool.PageGrant in paged mode
