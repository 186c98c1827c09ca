"""Double-buffered host → device input staging for windowed training
(counterpart of ``paddle_tpu/fluid/prefetch.py``).

A ``feed_per_step`` training loop reads window k's batches, stacks them to
``(n_steps, ...)`` arrays and copies them to the card between windows, so
the card idles while the host reads.  :class:`DevicePrefetcher` moves that
work onto a background thread with a bounded queue of staged windows:
while the card runs window k, the host already stacks window k+1.

On the card each window is stacked straight into pinned host memory and
copied by a side stream (``non_blocking``); the consumer's stream waits
on the copy's event before the window is handed out, and each tensor is
``record_stream``'d on the consumer's stream, so the allocator keeps it
until the consumer's work on it is done.  On the CPU the stacked arrays
become tensors.

Contract (the reference's):

 - bounded depth: at most ``depth`` staged windows are alive
   (``PADDLE_TPU_PREFETCH_DEPTH``, default 2 — double buffering);
 - a worker exception is raised in the consumer, not lost with the
   thread;
 - clean shutdown: an early-exiting consumer (``close()`` or ``break``)
   flips an abort event and the worker drains through timed puts, never
   wedging on a queue nobody reads;
 - ``depth=0`` stages synchronously in the caller's thread.

Each staged window first takes the fault layer's slow-input delay
(``fluid.fault.io_delay``, ``PADDLE_FAULT_IO_DELAY_MS``), as in the
reference.  The reference's trace spans and memory ledger come with
``observe`` (``ROADMAP.md`` queue 1 item 9).
"""

from __future__ import annotations

from queue import Empty, Full, Queue
from threading import Event, Thread
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "default_depth", "iter_device_samples"]

_END = object()


class _WorkerError:
    """An exception caught on the staging thread, queued so the consumer
    raises it."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def default_depth() -> int:
    """The configured prefetch depth (``PADDLE_TPU_PREFETCH_DEPTH``,
    default 2: one window in use, one staging)."""
    from . import envcontract

    try:
        return max(0, int(envcontract.get("PADDLE_TPU_PREFETCH_DEPTH")))
    except ValueError:
        return 2


def _resolve_device(place) -> torch.device:
    """The place's device: the card (``CUDAPlace(0)``) unless given."""
    from . import core

    return core.torch_device(place if place is not None
                             else core.CUDAPlace(0))


def _background_iter(src_iter, stage_fn, depth: int, abort: Event,
                     join: bool = False):
    """Yield ``stage_fn(item)`` for every item of ``src_iter``, staged on a
    background thread ``depth`` items ahead.  ``join``: closing the
    generator also waits for the thread to stop (its source must then
    return once the caller stops feeding it)."""
    q: Queue = Queue(maxsize=max(1, depth))

    def _put(item) -> bool:
        while not abort.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except Full:
                continue
        return False

    def work():
        try:
            for item in src_iter:
                if abort.is_set():
                    return
                if not _put(stage_fn(item)):
                    return
        except BaseException as exc:
            _put(_WorkerError(exc))
            return
        _put(_END)

    t = Thread(target=work, name="device-prefetch", daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=0.05)
            except Empty:
                if not t.is_alive() and q.empty():
                    return  # the worker stopped without posting (aborted)
                continue
            if item is _END:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        abort.set()
        if join:
            t.join()


def _windows(source, n_steps: int):
    batches = []
    for sample in source:
        batches.append(sample)
        if len(batches) == n_steps:
            yield batches
            batches = []
    if batches:
        yield batches  # the tail window (count < n_steps)


class _Stager:
    """Host arrays → tensors on ``device``: on the card through pinned
    memory and a side stream, with an event the consumer waits on."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def stage(self, arrays, stacked=False):
        """``({key: tensor}, event)`` for ``{key: array}`` or, with
        ``stacked``, ``{key: [arrays]}`` stacked along a new leading dim;
        the event is None on the CPU.  Each array is copied once into host
        memory of its own (pinned on the card)."""
        cuda = self.device.type == "cuda"
        host = {}
        for k, v in arrays.items():
            parts = [np.asarray(a) for a in v] if stacked else None
            first = parts[0] if stacked else np.asarray(v)
            shape = ((len(parts),) if stacked else ()) + first.shape
            t = torch.empty(shape, pin_memory=cuda, dtype=torch.from_numpy(
                np.empty(0, first.dtype)).dtype)
            if stacked:
                np.stack(parts, out=t.numpy())
            else:
                t.numpy()[...] = first
            host[k] = t
        if not cuda:
            return host, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = {k: h.to(self.device, non_blocking=True)
                   for k, h in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event


def _hand_over(tensors, event, device):
    """Make the consumer's stream wait for the staged copy and keep each
    tensor alive for the consumer's work on it."""
    if event is None:
        return
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(event)
    for t in tensors:
        t.record_stream(consumer)


class DevicePrefetcher:
    """Iterate ``(feed_dev, count)`` windows staged on the device.

    ``source`` is an iterable of per-step feed dicts (``{name: array}``);
    every ``n_steps`` consecutive dicts are stacked along a leading window
    dim and put on the device — ready for ``Executor.run_steps(feed=
    feed_dev, n_steps=count, feed_per_step=True)``.  The last window may be
    short (``count < n_steps``); the caller runs it with its count.
    ``place``: the device's place (default the card).  ``stage_fn``: takes
    the stacked window (``{name: array}``) and returns its tensors, ready
    on the device (``ParallelExecutor.stage_window``), in place of the
    default staging.
    """

    def __init__(self, source: Iterable[Dict[str, object]], n_steps: int = 1,
                 place=None, depth: Optional[int] = None, stage_fn=None):
        self.n_steps = max(1, int(n_steps))
        self.depth = default_depth() if depth is None else max(0, int(depth))
        self._source = source
        self._place = place
        self._stager = None
        self._stage_fn = stage_fn
        self._abort = Event()

    def _stage(self, batches) -> Tuple[Dict[str, torch.Tensor], int, object]:
        from . import fault as _fault

        _fault.io_delay()  # the deterministic slow-input oracle
        if self._stage_fn is not None:
            return self._stage_fn({name: np.stack([b[name] for b in batches])
                                   for name in batches[0]}), len(batches), None
        if self._stager is None:
            self._stager = _Stager(_resolve_device(self._place))
        staged, event = self._stager.stage(
            {name: [b[name] for b in batches] for name in batches[0]},
            stacked=True)
        return staged, len(batches), event

    def _yield(self, item):
        staged, count, event = item
        if event is not None:
            _hand_over(staged.values(), event, self._stager.device)
        return staged, count

    def __iter__(self):
        wins = _windows(self._source, self.n_steps)
        if self.depth == 0:
            for batches in wins:  # synchronous: staged on demand, here
                if self._abort.is_set():
                    return
                yield self._yield(self._stage(batches))
            return
        for item in _background_iter(wins, self._stage, self.depth,
                                     self._abort):
            yield self._yield(item)

    def close(self) -> None:
        """Stop the staging thread; safe to call more than once."""
        self._abort.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def iter_device_samples(reader, depth: Optional[int] = None, place=None):
    """Yield ``reader()``'s samples (a dict, tuple, list or array) with
    every numpy array already on the device, staged ``depth`` samples
    ahead on a background thread."""
    stager = _Stager(_resolve_device(place))
    depth = default_depth() if depth is None else max(1, int(depth))

    def stage(sample):
        if isinstance(sample, dict):
            items = list(sample.items())
        elif isinstance(sample, (tuple, list)):
            items = list(enumerate(sample))
        else:
            items = [(None, sample)]
        arrays = {k: v for k, v in items if isinstance(v, np.ndarray)}
        staged, event = stager.stage(arrays)
        out = [(k, staged.get(k, v) if isinstance(v, np.ndarray) else v)
               for k, v in items]
        if isinstance(sample, dict):
            return dict(out), staged, event
        if isinstance(sample, (tuple, list)):
            return type(sample)(v for _, v in out), staged, event
        return out[0][1], staged, event

    for sample, staged, event in _background_iter(iter(reader()), stage,
                                                  depth, Event()):
        _hand_over(staged.values(), event, stager.device)
        yield sample
