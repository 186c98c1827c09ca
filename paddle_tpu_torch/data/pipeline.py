"""Checkpointable streaming input pipeline (counterpart of
``paddle_tpu/data/pipeline.py``).

The reader decorators (``paddle_tpu_torch.reader.decorator``) are stateless
generator factories: kill a run mid-epoch and the only resume options are
"replay the epoch from sample 0" or "skip an unknowable number of
samples" — the one part of the stack the elastic supervisor and the
guardian cannot make deterministic.  This module makes iterator
position a first-class checkpoint artifact: every stage implements the
:class:`CheckpointableIterator` protocol (``state()`` / ``restore()``),
state blobs are plain JSON-serializable dicts small enough to commit with
every model checkpoint (one per host rank, under the same ``_SUCCESS``
marker — see ``paddle_tpu_torch.data.checkpoint``), and a restored pipeline
yields the byte-identical sample sequence an uninterrupted run would
have, starting at the first un-committed sample.

Stages (built fluently from :func:`from_reader`)::

    pipe = (data.from_reader(sample_reader)        # legacy reader adapter
                .shard(num_hosts, host_rank)       # or .shard_by_mesh()
                .shuffle(buf_size=512, seed=7)     # resumable, per-epoch
                .batch(64))                        # -> DataFeeder batches

 - ``shard(n, i)`` keeps every n-th sample (round-robin partition: no
   overlap, no loss across shards); ``shard_by_mesh`` derives ``(n, i)``
   from the named mesh (``data.sharding.shard_spec``): hosts in the
   same dp group read identical data, distinct dp groups partition it.
 - ``shuffle`` draws each buffer's permutation from a private
   ``random.Random`` keyed on ``(seed, epoch, buffer_index)`` — epoch N
   buffer k is reproducible *directly*, with no replay of prior epochs or
   buffers, which is what makes the cursor resumable mid-buffer.
 - ``batch`` groups samples into ``DataFeeder``-shaped lists and feeds
   the ``data.samples`` / ``data.bytes`` counters (:data:`COUNTERS`).

Epoch contract: a :class:`Pipeline` is callable like a legacy reader —
each call after a completed epoch advances to the next epoch (stages see
``set_epoch``); ``state()`` carries the epoch, so a restored pipeline
resumes mid-epoch N without consuming epochs 0..N-1.

Determinism notes: ``random.Random`` seeded with a string hashes it with
sha512 (not the randomized ``hash()``), so permutations reproduce across
processes; an unseeded ``shuffle`` is NOT checkpointable and ``state()``
says so loudly.  State snapshots are only consistent from the thread
driving the iterator — the prefetch wrapper
(:class:`paddle_tpu_torch.data.prefetch.CheckpointablePrefetcher`)
snapshots on its staging thread at window boundaries for exactly this
reason.

Counters (:data:`COUNTERS`, the reference's observe registry entries):
``data.samples`` and ``data.bytes`` per batch, ``data.wait_ms`` per input
wait, ``data.stall_events`` per wait above ``PADDLE_DATA_STALL_EVENT_MS``.
The reference's trace spans, SLO watchdog feed, goodput ledger and run
events come with ``observe`` (``ROADMAP.md`` queue 1 item 9).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterator, Optional

__all__ = [
    "CheckpointableIterator", "Pipeline", "from_reader",
    "is_checkpointable", "note_data_wait", "timed", "COUNTERS",
    "reset_counters",
]

#: the data plane's counters (samples and bytes batched, input wait in
#: ms, waits over PADDLE_DATA_STALL_EVENT_MS)
COUNTERS = {"data.samples": 0, "data.bytes": 0, "data.wait_ms": 0.0,
            "data.stall_events": 0}
_counters_lock = threading.Lock()


def _inc(name: str, value=1) -> None:
    with _counters_lock:
        COUNTERS[name] += value


def reset_counters() -> None:
    with _counters_lock:
        for k in COUNTERS:
            COUNTERS[k] = type(COUNTERS[k])()


class CheckpointableIterator:
    """The resumable-iterator protocol every pipeline stage implements.

    ``state()`` returns a JSON-serializable dict identifying the position
    of the FIRST SAMPLE NOT YET YIELDED; ``restore(state)`` repositions a
    freshly built, identically shaped pipeline there; ``set_epoch(e)``
    rewinds to the start of epoch ``e`` (stages that randomize re-key
    their RNG on it).  Iteration covers ONE epoch: ``__next__`` raises
    ``StopIteration`` at epoch end and the caller decides whether another
    epoch starts (``Pipeline.__call__``)."""

    def state(self) -> dict:
        raise NotImplementedError

    def restore(self, state: dict) -> None:
        raise NotImplementedError

    def set_epoch(self, epoch: int) -> None:
        raise NotImplementedError

    def __iter__(self):
        return self

    def __next__(self):
        raise NotImplementedError


def is_checkpointable(reader) -> bool:
    """True when ``reader`` speaks the state()/restore() protocol (the
    Trainer uses this to pick exact-resume over sample-skip replay)."""
    return isinstance(reader, CheckpointableIterator)


def _stage_rng(seed, epoch: int, index: int) -> random.Random:
    """Private RNG keyed on (seed, epoch, index).  String seeding goes
    through sha512 — deterministic across processes, unlike ``hash()`` —
    so a resumed subprocess reproduces the exact permutation."""
    return random.Random(f"{seed}|{epoch}|{index}")


class _ReaderSource(CheckpointableIterator):
    """Legacy-reader adapter: wraps a paddle-style reader factory (a
    callable returning a fresh per-epoch generator) with a sample-count
    cursor.  Restore re-instantiates the generator and skips ``cursor``
    samples — O(cursor) replay, the only generic contract an opaque
    generator admits; sources that can seek should implement the protocol
    directly."""

    def __init__(self, reader_fn: Callable[[], Iterator]):
        if not callable(reader_fn):
            raise TypeError(
                "from_reader wants a reader FACTORY (callable returning a "
                f"generator), got {type(reader_fn).__name__}")
        self._fn = reader_fn
        self.epoch = 0
        self.cursor = 0
        self._gen: Optional[Iterator] = None
        self._pending_skip = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self.cursor = 0
        self._gen = None
        self._pending_skip = 0

    def state(self) -> dict:
        return {"kind": "reader", "epoch": self.epoch, "cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self._gen = None
        self._pending_skip = self.cursor

    def __next__(self):
        from ..fluid import fault as _fault

        if self._gen is None:
            self._gen = iter(self._fn())
            for _ in range(self._pending_skip):
                next(self._gen)
            self._pending_skip = 0
        sample = next(self._gen)  # StopIteration = epoch end
        _fault.data_stall(self.cursor)  # deterministic slow-input oracle
        self.cursor += 1
        return sample


class _ShardStage(CheckpointableIterator):
    """Round-robin shard filter: keeps upstream samples whose ordinal
    satisfies ``i % num_shards == shard_index``.  Shards with distinct
    indices PARTITION the upstream stream (no overlap, no loss), which is
    the property the mesh test asserts for dp4 and dp2x tp2."""

    def __init__(self, up: CheckpointableIterator, num_shards: int,
                 shard_index: int):
        num_shards, shard_index = int(num_shards), int(shard_index)
        if num_shards < 1 or not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard: need 0 <= shard_index < num_shards, got "
                f"index={shard_index} of {num_shards}")
        self._up = up
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._seen = 0

    def set_epoch(self, epoch: int) -> None:
        self._up.set_epoch(epoch)
        self._seen = 0

    def state(self) -> dict:
        return {"kind": "shard", "seen": self._seen,
                "up": self._up.state()}

    def restore(self, state: dict) -> None:
        self._up.restore(state["up"])
        self._seen = int(state["seen"])

    def __next__(self):
        while True:
            sample = next(self._up)
            i = self._seen
            self._seen += 1
            if i % self.num_shards == self.shard_index:
                return sample


class _ShuffleStage(CheckpointableIterator):
    """Buffered shuffle whose cursor is resumable MID-BUFFER.

    Buffer ``k`` of epoch ``e`` is permuted by a private RNG keyed on
    ``(seed, e, k)``: reproducing any buffer needs neither the previous
    buffers nor previous epochs, so ``state()`` is just (upstream position
    at buffer start, buffer index, offset into the permuted buffer) and
    ``restore`` refills one buffer and skips to the offset."""

    def __init__(self, up: CheckpointableIterator, buf_size: int, seed=None):
        self._up = up
        self.buf_size = max(1, int(buf_size))
        self.seed = seed
        self.epoch = 0
        self._buf: Optional[list] = None
        self._off = 0
        self._buf_index = 0
        self._buf_start: Optional[dict] = None
        self._pending_off = 0

    def set_epoch(self, epoch: int) -> None:
        self._up.set_epoch(epoch)
        self.epoch = int(epoch)
        self._buf = None
        self._off = 0
        self._buf_index = 0
        self._buf_start = None
        self._pending_off = 0

    def state(self) -> dict:
        if self.seed is None:
            raise ValueError(
                "shuffle(seed=None) is not checkpointable: an unseeded "
                "permutation cannot be reproduced on restore — pass a seed")
        if self._buf is None or self._off >= len(self._buf):
            # buffer boundary: the next sample starts a fresh buffer at
            # the upstream's CURRENT position
            nxt = self._buf_index + (0 if self._buf is None else 1)
            return {"kind": "shuffle", "epoch": self.epoch,
                    "buf_index": nxt, "off": 0, "up": self._up.state()}
        return {"kind": "shuffle", "epoch": self.epoch,
                "buf_index": self._buf_index, "off": self._off,
                "up": self._buf_start}

    def restore(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._up.restore(state["up"])
        self._buf_index = int(state["buf_index"])
        self._buf = None
        self._off = 0
        self._buf_start = None
        self._pending_off = int(state["off"])

    def _refill(self) -> None:
        self._buf_start = self._up.state() if self.seed is not None else None
        buf = []
        try:
            while len(buf) < self.buf_size:
                buf.append(next(self._up))
        except StopIteration:
            pass
        if not buf:
            raise StopIteration
        rng = (random.Random() if self.seed is None
               else _stage_rng(self.seed, self.epoch, self._buf_index))
        rng.shuffle(buf)
        self._buf = buf
        self._off = min(self._pending_off, len(buf))
        self._pending_off = 0

    def __next__(self):
        if self._buf is not None and self._off >= len(self._buf):
            self._buf_index += 1
            self._buf = None
        if self._buf is None:
            self._refill()
        sample = self._buf[self._off]
        self._off += 1
        return sample


def _nbytes(obj) -> int:
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(x) for x in obj.values())
    return 8  # scalars / opaque python objects: a nominal word


class _BatchStage(CheckpointableIterator):
    """Group samples into ``DataFeeder``-shaped lists (the same surface
    as ``paddle.batch``).  State is the upstream position at the batch
    boundary — batches are the pipeline's atomic commit unit, so a
    checkpoint taken between batches resumes at the next batch's first
    sample with nothing split."""

    def __init__(self, up: CheckpointableIterator, batch_size: int,
                 drop_last: bool = False):
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._up = up
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)

    def set_epoch(self, epoch: int) -> None:
        self._up.set_epoch(epoch)

    def state(self) -> dict:
        return {"kind": "batch", "up": self._up.state()}

    def restore(self, state: dict) -> None:
        self._up.restore(state["up"])

    def __next__(self):
        buf = []
        try:
            while len(buf) < self.batch_size:
                buf.append(next(self._up))
        except StopIteration:
            if not buf or self.drop_last:
                raise StopIteration from None
        _inc("data.samples", len(buf))
        _inc("data.bytes", _nbytes(buf))
        return buf


class _MapStage(CheckpointableIterator):
    """Apply ``fn`` to every upstream item.  Stateless by construction —
    ``fn`` must be deterministic for resume to stay byte-identical; side
    effects re-fire on replayed (staged-but-uncommitted) items, which is
    exactly what the kill-and-resume oracle's recording map relies on."""

    def __init__(self, up: CheckpointableIterator, fn: Callable):
        self._up = up
        self._fn = fn

    def set_epoch(self, epoch: int) -> None:
        self._up.set_epoch(epoch)

    def state(self) -> dict:
        return {"kind": "map", "up": self._up.state()}

    def restore(self, state: dict) -> None:
        self._up.restore(state["up"])

    def __next__(self):
        return self._fn(next(self._up))


class Pipeline(CheckpointableIterator):
    """The user-facing handle over a stage chain: fluent builders, the
    legacy callable-reader surface, and whole-pipeline state.

    ``pipe()`` returns the epoch's iterator exactly like a decorated
    reader — but statefully: after an epoch completes, the next call
    advances every stage to the next epoch (shuffle re-keys its RNG), and
    after ``restore`` the next call resumes mid-epoch instead."""

    def __init__(self, stage: CheckpointableIterator, epoch: int = 0):
        self._stage = stage
        self.epoch = int(epoch)
        self._epoch_done = False

    # -- builders ----------------------------------------------------------
    def shard(self, num_shards: int, shard_index: int) -> "Pipeline":
        return Pipeline(_ShardStage(self._stage, num_shards, shard_index),
                        self.epoch)

    def shard_by_mesh(self, mesh=None, host_rank: Optional[int] = None,
                      num_hosts: Optional[int] = None) -> "Pipeline":
        """Shard for this host's slice of the named mesh (a spec string,
        or ``PADDLE_TPU_MESH``):
        ``data.sharding.shard_spec`` maps (mesh, host) to a round-robin
        ``(num_shards, shard_index)`` — tp/fsdp replicas read identical
        data, distinct dp groups partition it."""
        from .sharding import shard_spec

        n, i = shard_spec(mesh, host_rank=host_rank, num_hosts=num_hosts)
        return self.shard(n, i)

    def shuffle(self, buf_size: int, seed=None) -> "Pipeline":
        return Pipeline(_ShuffleStage(self._stage, buf_size, seed),
                        self.epoch)

    def batch(self, batch_size: int, drop_last: bool = False) -> "Pipeline":
        return Pipeline(_BatchStage(self._stage, batch_size, drop_last),
                        self.epoch)

    def map(self, fn: Callable) -> "Pipeline":
        return Pipeline(_MapStage(self._stage, fn), self.epoch)

    # -- protocol ----------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self._epoch_done = False
        self._stage.set_epoch(self.epoch)

    def state(self) -> dict:
        return {"version": 1, "epoch": self.epoch,
                "epoch_done": self._epoch_done, "stage": self._stage.state()}

    def restore(self, state: dict) -> None:
        if int(state.get("version", -1)) != 1:
            raise ValueError(
                f"data_state version {state.get('version')!r} is not "
                f"readable by this pipeline (expected 1)")
        self.epoch = int(state["epoch"])
        self._epoch_done = bool(state.get("epoch_done", False))
        # set_epoch first: it zeroes every stage's counters, then the
        # stage-state restore repositions them (a restore into a pipeline
        # mid-iteration must not inherit stale cursors)
        self._stage.set_epoch(self.epoch)
        self._stage.restore(state["stage"])

    def __next__(self):
        try:
            return next(self._stage)
        except StopIteration:
            self._epoch_done = True
            raise

    def __call__(self):
        """Legacy reader surface (``for batch in pipe():``): a call after
        a completed epoch starts the next one; a call after ``restore``
        (or the first call) continues from the current cursor."""
        if self._epoch_done:
            self.set_epoch(self.epoch + 1)
        return iter(self)


def from_reader(reader_fn: Callable[[], Iterator]) -> Pipeline:
    """Wrap a legacy paddle-style reader factory as a checkpointable
    pipeline source (sample-count cursor; see :class:`_ReaderSource`)."""
    return Pipeline(_ReaderSource(reader_fn))


# ---------------------------------------------------------------------------
# data-wait accounting (shared by the prefetch wrapper and the trainer's
# per-step loop)
# ---------------------------------------------------------------------------


def note_data_wait(wait_s: float, **ctx) -> None:
    """Record one input-wait interval: ``data.wait_ms``, and
    ``data.stall_events`` when the wait exceeds
    ``PADDLE_DATA_STALL_EVENT_MS``.  ``ctx`` (the epoch, a window's step
    count) is accepted as in the reference, whose run events carry it."""
    from ..fluid import envcontract

    wait_ms = float(wait_s) * 1000.0
    _inc("data.wait_ms", wait_ms)
    if wait_ms > float(envcontract.get("PADDLE_DATA_STALL_EVENT_MS")):
        _inc("data.stall_events")


def timed(iterator, **ctx):
    """Yield from ``iterator``, feeding every item's pull time through
    :func:`note_data_wait` (the per-step training loop's input-wait
    accounting; the windowed loop gets the same from
    :class:`~paddle_tpu_torch.data.prefetch.CheckpointablePrefetcher`)."""
    it = iter(iterator)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        note_data_wait(time.perf_counter() - t0, **ctx)
        yield item
