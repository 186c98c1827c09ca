"""Bounded retry for transient I/O on durable-state paths (counterpart of
``paddle_tpu/fluid/retry.py``).

:func:`retry_io` wraps each checkpoint file read and write of
``fluid.io``: an ``OSError`` means *transient* and earns bounded retry
with exponential backoff; anything else (``ValueError`` from a torn npy
header, ``EOFError``) means *content*, is never retried, and flows to the
caller.  ``PADDLE_FAULT_IO_ERROR_RATE`` (``fluid.fault.io_error``) drives
the retry path deterministically.  (The reference also counts each retry
in its metrics registry, which the port does not have yet.)
"""

from __future__ import annotations

import time
from typing import Callable, Optional, TypeVar

from . import envcontract as _ec

__all__ = ["retry_io"]

T = TypeVar("T")

#: backoff ceiling between attempts
_MAX_DELAY_S = 2.0


def retry_io(fn: Callable[[], T], *, what: str,
             attempts: Optional[int] = None,
             base_s: Optional[float] = None,
             sleep: Callable[[float], None] = time.sleep) -> T:
    """Run ``fn`` (a zero-arg I/O closure) for call site ``what``,
    retrying ``OSError`` up to ``attempts`` tries in all, ``base_s *
    2**k`` seconds (at most 2 s) before try ``k + 1``.  Defaults come live
    from ``PADDLE_IO_RETRIES`` and ``PADDLE_IO_RETRY_BASE_S``.  The last
    failure re-raises its ``OSError``."""
    if attempts is None:
        attempts = int(_ec.get("PADDLE_IO_RETRIES"))
    if base_s is None:
        base_s = float(_ec.get("PADDLE_IO_RETRY_BASE_S"))
    attempts = max(1, int(attempts))
    last: Optional[OSError] = None
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as exc:
            last = exc
            if attempt + 1 >= attempts:
                break
            sleep(min(float(base_s) * 2.0 ** attempt, _MAX_DELAY_S))
    assert last is not None
    raise last
