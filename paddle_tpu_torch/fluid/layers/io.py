"""Data layers and the in-graph readers (counterpart of
``paddle_tpu/fluid/layers/io.py``; upstream's ``python/paddle/fluid/layers/
io.py``: ``data``, ``py_reader``, ``open_recordio_file``, ``open_files``,
``batch``, ``shuffle``, ``double_buffer``, ``read_file``, ...).

A reader is a ``READER`` var with host-side state (:class:`ReaderState`):
a native bounded byte queue (``paddle_tpu_torch/native``) that a producer
thread fills with packed batches.  ``read_file`` adds a ``read`` op whose
outputs are data vars; before each step ``Executor.run`` pops one batch per
``read`` op into the feed (``core.EOFException`` at the end of the data), so
the step itself is an ordinary fed step.  ``double_buffer`` stages the next
batches on the device while the current step runs: a thread copies each
batch into pinned memory and onto the card on a side stream, with the
event and ``record_stream`` hand-over of ``fluid/prefetch.py``; the read op
then hands the step tensors that are already there.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import core, unique_name
from ..framework import default_main_program

__all__ = ["data", "py_reader", "read_file", "open_recordio_file",
           "open_files", "random_data_generator", "Preprocessor",
           "ParallelDo", "batch",
           "shuffle", "double_buffer", "create_py_reader_by_data"]

#: batches ``double_buffer`` stages ahead of the step that reads them
DOUBLE_BUFFER_DEPTH = 2
# ``double_buffer`` with no place: stage on the device of the Executor that
# runs the read op
_EXECUTOR_DEVICE = "executor"


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(
        name=name, shape=shape, dtype=core.convert_dtype(dtype),
        lod_level=lod_level, stop_gradient=stop_gradient, is_data=True)


# ---------------------------------------------------------------------------
# reader state (host side)
# ---------------------------------------------------------------------------

_READERS: Dict[str, "ReaderState"] = {}


def _reader_state(name: str) -> "ReaderState":
    try:
        return _READERS[name]
    except KeyError:
        raise RuntimeError(f"reader '{name}' has no runtime state — was it "
                           f"created by py_reader/open_recordio_file?") \
            from None


class ReaderState:
    """Host-side state of one reader var (upstream's create_py_reader_op.cc
    over a LoDTensorBlockingQueue): a native bounded byte queue and a
    producer thread.

    A source yields *item lists* (``[(array, lod offsets), ...]``, one item
    a slot); the producer applies the ``shuffle`` / ``batch`` decorators,
    packs each batch (``native.tensor_pack``) and pushes it.  A producer
    exception is raised at ``next_batch`` as ``RuntimeError``, not taken
    for the end of the data.  ``stats`` counts the batches popped and the
    seconds ``next_batch`` waited for them."""

    def __init__(self, name: str, capacity: int, shapes, dtypes, lod_levels,
                 batch_size: Optional[int] = None):
        from ...native import BlockingQueue

        self.name = name
        self.queue = BlockingQueue(capacity)
        self.shapes = shapes
        self.dtypes = dtypes
        self.lod_levels = lod_levels
        self.batch_size = batch_size
        self.shuffle_buf = 0
        #: batch -> batch functions applied after the pop (``Preprocessor``)
        self.transforms: List = []
        #: None, or the place ``double_buffer`` stages on
        self.double_buffer = None
        self.stats = {"pops": 0, "wait_s": 0.0}
        self._producer = None
        self._source = None          # callable -> iterable of item lists
        self._started = False
        self._error = None
        self._staged = None          # the staging generator
        self._stager = None

    # -- user surface (upstream's py_reader methods) --
    def _minibatch_items(self, minibatch):
        """A list of sample tuples -> an item list, through the
        DataFeeder's converters (one a slot, fed every sample)."""
        from ..data_feeder import DataToLoDTensorConverter
        from ..lod_tensor import LoDTensor

        convs = [DataToLoDTensorConverter(None, lod_level, shape, dtype)
                 for shape, dtype, lod_level in zip(self.shapes, self.dtypes,
                                                    self.lod_levels)]
        for sample in minibatch:
            for conv, slot in zip(convs, sample):
                conv.feed(slot)
        items = []
        for conv in convs:
            done = conv.done()
            if isinstance(done, LoDTensor):
                items.append((np.asarray(done), done.lod()))
            else:
                items.append((np.asarray(done), ()))
        return items

    def decorate_paddle_reader(self, reader, places=None):
        """``reader``: a callable -> iterable of MINIBATCHES (lists of
        sample tuples, what ``paddle.batch(...)`` yields), upstream's
        ``decorate_paddle_reader`` contract."""

        def source():
            for minibatch in reader():
                yield self._minibatch_items(minibatch)

        self._source = source

    def decorate_sample_reader(self, reader, places=None):
        """``reader`` yields single sample tuples; ``layers.batch(reader_var,
        n)`` groups them into minibatches."""

        def source():
            for sample in reader():
                yield self._minibatch_items([sample])

        self._source = source

    def decorate_tensor_provider(self, provider):
        """``provider``: a callable -> iterable of batches: lists of arrays,
        LoDTensors, or ``(array, recursive_seq_lens)`` tuples."""

        def source():
            from ..lod_tensor import LoDTensor, _lengths_to_offsets

            for batch in provider():
                items = []
                for v in batch:
                    if isinstance(v, LoDTensor):
                        items.append((np.asarray(v), v.lod()))
                    elif isinstance(v, tuple) and len(v) == 2:
                        arr, lens = v
                        lod = tuple(tuple(_lengths_to_offsets(n))
                                    for n in lens)
                        items.append((np.asarray(arr), lod))
                    else:
                        items.append((np.asarray(v), ()))
                yield items

        self._source = source

    def _decorated(self):
        """The source's item lists through the shuffle and batch
        decorators."""
        import random

        merger = _BatchMerger(self.batch_size) if self.batch_size else None
        buf = []

        def emit(items):
            if merger is None:
                return items
            return merger.add(items)

        for items in self._source():
            if self.shuffle_buf:
                buf.append(items)
                if len(buf) < self.shuffle_buf:
                    continue
                items = buf.pop(random.randrange(len(buf)))
            out = emit(items)
            if out is not None:
                yield out
        while buf:
            out = emit(buf.pop(random.randrange(len(buf))))
            if out is not None:
                yield out
        if merger is not None:
            rest = merger.flush()
            if rest is not None:
                yield rest

    def start(self):
        if self._source is None:
            raise RuntimeError("reader has no data source; call "
                               "decorate_paddle_reader/tensor_provider")
        if self._started:
            return
        self._stop_staging()
        self.queue.reopen()
        self._started = True
        self._error = None

        def run():
            from ...native.tensor_pack import pack_batch

            try:
                for items in self._decorated():
                    if not self.queue.push(pack_batch(items)):
                        return           # closed under us (reset)
            except BaseException as e:   # raised at next_batch
                self._error = e
            finally:
                self.queue.close()

        self._producer = threading.Thread(target=run, daemon=True,
                                          name=f"reader-{self.name}")
        self._producer.start()

    def reset(self):
        self.queue.close()
        if self._producer is not None:
            self._producer.join(timeout=5)
        self._producer = None
        self._stop_staging()
        self._started = False

    def _stop_staging(self):
        staged, self._staged = self._staged, None
        if staged is not None:
            staged.close()  # stops and joins the staging thread

    # -- executor surface --
    def _host_batch(self):
        """The next batch as host arrays: ``[(array, lod offsets), ...]``,
        through the ``transforms``; raises ``core.EOFException``."""
        from ...native.tensor_pack import unpack_batch

        packed = self.queue.pop()
        if packed is None:
            self._started = False
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError(
                    f"reader {self.name}: producer thread failed") from err
            raise core.EOFException(f"reader {self.name} exhausted")
        batch = unpack_batch(packed)
        for transform in self.transforms:
            batch = transform(batch)
        return batch

    def _staged_batch(self, device):
        """The next batch as tensors on the staging device, staged
        ``DOUBLE_BUFFER_DEPTH`` batches ahead on a thread of its own."""
        from ..prefetch import _background_iter, _hand_over, _Stager

        if self._staged is None:
            place = self.double_buffer
            stager = self._stager = _Stager(
                device if place == _EXECUTOR_DEVICE
                else core.torch_device(place))

            def source():
                while True:
                    try:
                        yield self._host_batch()
                    except core.EOFException:
                        return

            def stage(batch):
                staged, event = stager.stage(
                    {i: arr for i, (arr, _) in enumerate(batch)})
                return ([(staged[i], lod) for i, (_, lod) in
                         enumerate(batch)], event)

            self._staged = _background_iter(
                source(), stage, DOUBLE_BUFFER_DEPTH, threading.Event(),
                join=True)
        try:
            batch, event = next(self._staged)
        except StopIteration:
            self._staged = None
            raise core.EOFException(f"reader {self.name} exhausted") \
                from None
        except BaseException:
            self._staged = None
            raise
        _hand_over([t for t, _ in batch], event, self._stager.device)
        return batch

    def next_batch(self, device=None):
        """The next batch, ``[(value, lod offsets), ...]``: host arrays, or
        with ``double_buffer`` tensors on its place (``device``, the
        Executor's, when it named none).  Raises ``core.EOFException`` at
        the end of the data."""
        t0 = time.perf_counter()
        try:
            if self.double_buffer is None:
                return self._host_batch()
            return self._staged_batch(device)
        finally:
            self.stats["pops"] += 1
            self.stats["wait_s"] += time.perf_counter() - t0


class _ReaderVar:
    """The Variable with the reader's controls attached."""

    def __new__(cls, var, state):
        var._reader_state = state
        var.start = state.start
        var.reset = state.reset
        var.decorate_paddle_reader = state.decorate_paddle_reader
        var.decorate_tensor_provider = state.decorate_tensor_provider
        return var


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Upstream's ``layers/io.py`` ``py_reader``: a reader var fed by
    ``decorate_paddle_reader()`` / ``decorate_tensor_provider()`` once
    ``start()`` is called.  ``use_double_buffer`` stages its batches on
    the running Executor's device (``double_buffer``)."""
    block = default_main_program().current_block()
    name = name or unique_name.generate("py_reader")
    shapes = [list(s) for s in shapes]
    dtypes = [core.convert_dtype(d) for d in dtypes]
    lod_levels = list(lod_levels or [0] * len(shapes))
    reader = block.create_var(name=name, type=core.VarType.READER)
    state = ReaderState(name, capacity, shapes, dtypes, lod_levels)
    _READERS[name] = state
    block.append_op(type="create_py_reader", inputs={},
                    outputs={"Out": [reader]},
                    attrs={"shape_concat": [d for s in shapes for d in s],
                           "lod_levels": lod_levels,
                           "capacity": capacity})
    reader = _ReaderVar(reader, state)
    return double_buffer(reader) if use_double_buffer else reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    shapes = [list(v.shape) for v in feed_list]
    dtypes = [v.dtype for v in feed_list]
    lod_levels = [v.lod_level for v in feed_list]
    return py_reader(capacity, shapes, dtypes, lod_levels, name,
                     use_double_buffer)


def read_file(reader):
    """The reader's outputs as data vars, written by a ``read`` op that
    ``Executor.run`` serves from the reader's queue."""
    state = _reader_state(reader.name)
    block = default_main_program().current_block()
    outs = []
    for i, (shape, dtype, lod_level) in enumerate(
            zip(state.shapes, state.dtypes, state.lod_levels)):
        v = block.create_var(name=f"{reader.name}__out_{i}", shape=shape,
                             dtype=dtype, lod_level=lod_level,
                             stop_gradient=True, is_data=True)
        outs.append(v)
    block.append_op(type="read", inputs={"Reader": [reader]},
                    outputs={"Out": [v.name for v in outs]})
    return outs[0] if len(outs) == 1 else outs


def _packed_records(records):
    from ...native.tensor_pack import unpack_batch

    for rec in records:
        yield list(unpack_batch(rec))


def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       pass_num=1, for_parallel=False):
    """A reader over a recordio file written by ``fluid.recordio_writer``
    (one packed sample a record)."""
    rd = py_reader(capacity=64, shapes=shapes, dtypes=dtypes,
                   lod_levels=lod_levels, use_double_buffer=False)

    def source():
        from ...native import RecordIOScanner

        for _ in range(pass_num):
            with RecordIOScanner(filename) as sc:
                yield from _packed_records(sc)

    rd._reader_state._source = source
    return rd


def open_files(filenames, shapes, dtypes, lod_levels=None,
               thread_num=2, buffer_size=256, pass_num=1):
    """One reader over many recordio shards, read by the native
    prefetcher's C++ threads (``native/prefetch.cc``: file reads and
    decompression off the Python thread); shards are dealt round-robin to
    the ``thread_num`` threads, so one thread keeps the file order."""
    rd = py_reader(capacity=buffer_size, shapes=shapes, dtypes=dtypes,
                   lod_levels=lod_levels, use_double_buffer=False)

    def source():
        from ...native import PrefetchReader

        for _ in range(pass_num):
            yield from _packed_records(PrefetchReader(
                list(filenames), n_threads=thread_num, capacity=buffer_size))

    rd._reader_state._source = source
    return rd


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=False):
    """A reader of uniform random float32 batches without end (upstream's
    create_random_data_generator_op.cc), drawn from ``RandomState(0)`` as
    the reference draws them."""
    dtypes = ["float32"] * len(shapes)
    rd = py_reader(capacity=16, shapes=shapes, dtypes=dtypes,
                   lod_levels=lod_levels, use_double_buffer=False)

    def source():
        rng = np.random.RandomState(0)
        while True:
            yield [(rng.uniform(low, high, size=[max(1, d if d not in
                    (-1, None) else 1) for d in shape])
                    .astype(np.float32), None)
                   for shape in shapes]

    rd._reader_state._source = source
    return rd


class _BatchMerger:
    """Merges per-sample records into batches (concatenated along dim 0,
    the LoD offsets merged)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.samples: List = []

    def add(self, items):
        self.samples.append(items)
        if len(self.samples) >= self.batch_size:
            return self.flush()
        return None

    def flush(self):
        if not self.samples:
            return None
        n_slots = len(self.samples[0])
        merged = []
        for i in range(n_slots):
            arrs = [s[i][0] for s in self.samples]
            lods = [s[i][1] for s in self.samples]
            data = np.concatenate(arrs, axis=0)
            if lods[0]:
                levels = []
                for lv in range(len(lods[0])):
                    off = [0]
                    for lod in lods:
                        base = off[-1]
                        off.extend(base + int(x) for x in lod[lv][1:])
                    levels.append(tuple(off))
                merged.append((data, tuple(levels)))
            else:
                merged.append((data, ()))
        self.samples = []
        return merged


def batch(reader, batch_size):
    """Group the reader's per-sample records into batches."""
    _reader_state(reader.name).batch_size = batch_size
    return reader


def shuffle(reader, buffer_size):
    """Shuffle through a bounded buffer (draws from the ``random`` module)."""
    _reader_state(reader.name).shuffle_buf = buffer_size
    return reader


def double_buffer(reader, place=None, name=None):
    """Stage the reader's next batches on ``place`` (default: the device
    of the Executor that runs the read op) while the current step runs:
    pinned memory and a side-stream copy on the card, tensors on the CPU.
    The batches are bitwise those without it."""
    _reader_state(reader.name).double_buffer = (
        place if place is not None else _EXECUTOR_DEVICE)
    return reader


class Preprocessor:
    """A sub-program applied to every batch a reader produces (upstream's
    ``layers/io.py`` ``Preprocessor``).  The transform is IR built inside
    ``block()``; each popped batch runs through it on the host
    (``CPUPlace()``), before ``double_buffer`` stages it.

    Example::

        pre = fluid.layers.Preprocessor(reader)
        with pre.block():
            img, lbl = pre.inputs()
            img = fluid.layers.scale(img, scale=1.0 / 255.0)
            pre.outputs(img, lbl)
        x, y = fluid.layers.read_file(pre())
    """

    def __init__(self, reader, name=None):
        self._reader = reader
        self._state = reader._reader_state
        self._prog = None
        self._in_vars = None
        self._out_vars = None
        self._applied = False

    def block(self):
        import contextlib

        from ..framework import Program, program_guard

        @contextlib.contextmanager
        def _ctx():
            self._prog = Program()
            self._startup = Program()
            with program_guard(self._prog, self._startup):
                yield self
            if self._out_vars is None:
                raise ValueError(
                    "Preprocessor.block() ended without outputs(...)")
            # read_file declares its outputs from the reader's metadata,
            # which must describe the TRANSFORMED batches
            self._state.shapes = [list(v.shape) if v.shape else [-1]
                                  for v in self._out_vars]
            self._state.dtypes = [str(v.dtype) for v in self._out_vars]
            self._state.lod_levels = (
                list(self._state.lod_levels[:len(self._out_vars)])
                + [0] * max(0, len(self._out_vars)
                            - len(self._state.lod_levels)))

        return _ctx()

    def inputs(self):
        block = default_main_program().current_block()
        self._in_vars = [
            block.create_var(name=unique_name.generate("preprocessor_in"),
                             shape=tuple(shape), dtype=dtype, is_data=True)
            for shape, dtype in zip(self._state.shapes, self._state.dtypes)]
        return self._in_vars

    def outputs(self, *outs):
        self._out_vars = list(outs)

    def __call__(self):
        from ..executor import Executor
        from ..lod_tensor import LoDTensor

        if self._out_vars is None:
            raise ValueError(
                "Preprocessor: define the transform inside `with "
                "pre.block():` before calling pre()")
        if self._applied:
            return self._reader  # never transform twice
        self._applied = True
        exe = Executor(core.CPUPlace())
        exe.run(self._startup)
        prog = self._prog
        in_names = [v.name for v in self._in_vars]
        out_names = [v.name for v in self._out_vars]

        def transform(batch):
            feed = {n: (LoDTensor(a, lod) if lod else a)
                    for n, (a, lod) in zip(in_names, batch)}
            outs = exe.run(prog, feed=feed, fetch_list=out_names,
                           return_numpy=False)
            # a fetch with a LoD comes back as a LoDTensor
            return [(np.asarray(o), o.lod()) if isinstance(o, LoDTensor)
                    else (o.numpy(), ()) for o in outs]

        self._state.transforms.append(transform)
        return self._reader


class ParallelDo:
    """Upstream's deprecated in-graph data parallelism (parallel_do_op.cc).
    The reference replaced it by ``ParallelExecutor``; the port's
    port's counterpart is ``fluid.ParallelExecutor`` (data parallelism over
    a process group)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "ParallelDo was replaced by ParallelExecutor (data parallelism "
            "over the devices): use fluid.ParallelExecutor")
