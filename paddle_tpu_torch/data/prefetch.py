"""Checkpointable device prefetch: staged-but-uncommitted is REPLAYED
(counterpart of ``paddle_tpu/data/prefetch.py``).

:class:`~paddle_tpu_torch.fluid.prefetch.DevicePrefetcher` runs ahead of
the training loop by design — when a window is dispatched, the staging
thread has already pulled (and copied to the card) one or more FUTURE windows
from the pipeline.  Snapshotting ``pipeline.state()`` from the consumer
at checkpoint time would therefore record the PREFETCH HEAD, and a resume
would silently skip every staged-but-never-trained sample.

:class:`CheckpointablePrefetcher` fixes the attribution: on the staging
thread, immediately after window ``k``'s batches are pulled (and before
window ``k+1``'s first pull — the stage callback runs between the two),
it snapshots the pipeline state, which at that instant points at window
``k+1``'s first sample.  The snapshots ride a FIFO next to the staged
windows (the ``_stage_spans`` pattern), and as the consumer takes window
``k`` it pops the matching snapshot into ``last_state``.  A checkpoint
committed after training window ``k`` therefore records "resume at
window ``k+1``'s first sample": windows still sitting in the prefetch
queue are re-staged from the pipeline on restore — replayed, never lost.

The consumer side also accounts every window's input-wait through
``data.note_data_wait`` (the ``data.wait_ms`` and ``data.stall_events``
counters), so an injected ``PADDLE_FAULT_DATA_STALL_MS`` stall shows
there.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable, Optional

from ..fluid.prefetch import DevicePrefetcher
from .pipeline import CheckpointableIterator, note_data_wait

__all__ = ["CheckpointablePrefetcher"]


class CheckpointablePrefetcher(DevicePrefetcher):
    """A :class:`DevicePrefetcher` over a checkpointable pipeline.

    ``source`` is the per-step feed iterable (usually ``feeder.feed(b)
    for b in pipeline()``) and ``pipeline`` the
    :class:`~paddle_tpu_torch.data.pipeline.CheckpointableIterator` that
    ultimately produces it — the two must be the same stream: every
    ``source`` item must pull exactly one pipeline batch, lazily, on the
    pulling thread (a generator expression does; a pre-built list does
    not).  ``last_state`` always holds the state blob to commit for the
    windows consumed SO FAR."""

    def __init__(self, source: Iterable[Dict[str, object]],
                 pipeline: CheckpointableIterator, n_steps: int = 1,
                 place=None, depth: Optional[int] = None, stage_fn=None):
        super().__init__(source, n_steps=n_steps, place=place, depth=depth,
                         stage_fn=stage_fn)
        self._pipeline = pipeline
        self._win_states: deque = deque()
        #: resume point covering everything consumed so far; before any
        #: window is taken this is the pipeline's current (start) state
        self.last_state: dict = pipeline.state()

    def _stage(self, batches):
        item = super()._stage(batches)
        # runs on the staging thread BETWEEN window pulls: the pipeline
        # cursor now points at the first sample after this window — the
        # exact resume point once this window commits
        self._win_states.append(self._pipeline.state())
        return item

    def __iter__(self):
        it = super().__iter__()
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            wait_s = time.perf_counter() - t0
            if self._win_states:
                self.last_state = self._win_states.popleft()
            note_data_wait(wait_s, count=item[1])
            yield item
