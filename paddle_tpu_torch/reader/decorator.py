"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
upstream python/paddle/reader/decorator.py:36-443), stdlib only."""

from __future__ import annotations

import itertools
import random
from queue import Empty, Full, Queue
from threading import Event, Thread

__all__ = ["PipeReader", "map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "device_buffered"]


class _WorkerError:
    """Exception captured in a reader worker thread, queued so the CONSUMER
    re-raises it.  Without this, a raising worker dies before posting the
    end sentinel and the consumer deadlocks on q.get() forever."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size, seed=None):
    """Buffered shuffle.  ``seed`` pins the permutation to a private
    ``random.Random`` (NOT the global module state some other library may
    have reseeded), so data order is reproducible — and therefore
    recordable/replayable by the guardian's flight recorder.

    Each call of the returned reader is one EPOCH, and epoch ``e``'s RNG
    is derived from ``(seed, e)`` — not one stream threaded across
    epochs — so epoch N's order is reproducible directly: a restarted
    run calls ``data_reader.set_epoch(N)`` and gets epoch N's exact
    permutation without replaying epochs ``0..N-1`` (the resumable-
    shuffle contract ``paddle_tpu_torch.data`` builds on; one shared stream
    silently drifts the order on every restart).  A fresh decorator
    starts at epoch 0, so same-seed decorators still agree.  String
    seeding hashes via sha512, so the order also reproduces across
    processes.  ``seed=None`` keeps independent randomness."""
    epoch_box = [0]

    def set_epoch(epoch):
        epoch_box[0] = int(epoch)

    def data_reader():
        epoch = epoch_box[0]
        epoch_box[0] = epoch + 1
        rng = random.Random(None if seed is None else f"{seed}|{epoch}")
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b

    data_reader.set_epoch = set_epoch
    return data_reader


def chain(*readers):
    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in zip_longest_check(*rs):
                yield sum(list(map(make_tuple, outputs)), ())

    def zip_longest_check(*iters):
        sentinel = object()
        for row in itertools.zip_longest(*iters, fillvalue=sentinel):
            if sentinel in row:
                raise ComposeNotAligned("readers have different lengths")
            yield row

    return reader


def buffered(reader, size):
    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        try:
            for d in r:
                q.put(d)
        except BaseException as exc:
            # surface the failure to the consumer instead of dying
            # silently (which would hang the consumer's q.get() forever)
            q.put(_WorkerError(exc))
        else:
            q.put(end)

    def data_reader():
        r = reader()
        q = Queue(maxsize=size)
        t = Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            if isinstance(e, _WorkerError):
                raise e.exc
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel-map a reader with worker threads (upstream
    decorator.py:243).  ``order=True`` yields the results in the source's
    order, as upstream does (the JAX package's copy ignores ``order``).

    A raising ``mapper`` (or source reader) propagates to the consumer
    instead of silently killing its thread — which would leave ``end``
    unposted and the consumer blocked on ``out_q.get()`` forever.  On
    error the consumer flips an abort event; feeder and workers use
    timeout-puts so a full queue can never wedge the drain."""
    end = object()

    def data_reader():
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)
        abort = Event()

        def _put(q, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except Full:
                    continue
            return False

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not _put(in_q, (i, sample)):
                        return
            except BaseException as exc:
                _put(out_q, _WorkerError(exc))
                return
            for _ in range(process_num):
                if not _put(in_q, end):
                    return

        def work():
            while True:
                try:
                    sample = in_q.get(timeout=0.05)
                except Empty:
                    if abort.is_set():
                        return
                    continue
                if sample is end:
                    _put(out_q, end)
                    return
                i, sample = sample
                try:
                    result = mapper(sample)
                except BaseException as exc:
                    _put(out_q, _WorkerError(exc))
                    return
                if not _put(out_q, (i, result)):
                    return

        feeder = Thread(target=feed)
        feeder.daemon = True
        feeder.start()
        workers = []
        for _ in range(process_num):
            w = Thread(target=work)
            w.daemon = True
            w.start()
            workers.append(w)
        finished, nxt, held = 0, 0, {}
        try:
            while finished < process_num:
                sample = out_q.get()
                if isinstance(sample, _WorkerError):
                    raise sample.exc
                if sample is end:
                    finished += 1
                elif not order:
                    yield sample[1]
                else:
                    held[sample[0]] = sample[1]
                    while nxt in held:
                        yield held.pop(nxt)
                        nxt += 1
        finally:
            # stops on error AND on an early-exiting consumer (firstn):
            # the remaining threads drain via their timeout loops instead
            # of blocking forever on a queue nobody reads
            abort.set()

    return data_reader


def device_buffered(reader, size=None, place=None):
    """Like :func:`buffered`, but the worker thread also issues the
    host→device transfer for every array in the sample, so samples arrive
    at the consumer already device-resident — the H2D copy overlaps the
    consumer's compute instead of serializing with it (the Executor takes
    a tensor already on its device as it is, ``Executor._coerce_feed``).

    ``size`` bounds the number of in-flight staged samples (default
    ``PADDLE_TPU_PREFETCH_DEPTH``); worker exceptions propagate to the
    consumer and an early-exiting consumer never wedges the worker — the
    same contract as :func:`buffered`/:func:`xmap_readers`.  For staging
    whole ``run_steps`` windows, use
    :class:`paddle_tpu_torch.fluid.prefetch.DevicePrefetcher`, which this
    delegates to."""

    def data_reader():
        from ..fluid.prefetch import iter_device_samples

        yield from iter_device_samples(reader, depth=size, place=place)

    return data_reader


def cache(reader):
    all_data = []

    def cache_reader():
        if not all_data:
            all_data.extend(reader())
        for d in all_data:
            yield d

    return cache_reader


class PipeReader:
    """Stream records from a shell command's stdout (ref:
    python/paddle/reader/decorator.py:438 — used to read sharded datasets
    from `hadoop fs -cat` style pipes).  ``get_line`` yields decoded lines
    split on ``line_break``; callers parse each into a sample."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("PipeReader command must be a string")
        import subprocess

        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)
        if file_type == "gzip":
            import zlib

            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        elif file_type != "plain":
            raise TypeError(f"file_type {file_type} is not allowed")

    def close(self):
        if self.process.poll() is None:
            self.process.terminate()
        if self.process.stdout and not self.process.stdout.closed:
            self.process.stdout.close()
        self.process.wait()

    def get_line(self, cut_lines=True, line_break="\n"):
        import codecs
        import zlib

        # incremental decoder: a multibyte UTF-8 char split across the
        # bufsize boundary must not be dropped
        decoder = codecs.getincrementaldecoder("utf-8")("ignore")
        remained = ""
        try:
            while True:
                buff = self.process.stdout.read(self.bufsize)
                if not buff:
                    break
                if self.file_type == "gzip":
                    out = [self.dec.decompress(buff)]
                    # concatenated members (one per shard in `cat *.gz`
                    # pipes): restart the decompressor on leftover bytes —
                    # but only when they start a real member; gzip(1)
                    # tolerates trailing garbage (block padding) and so
                    # must we
                    while self.dec.eof and \
                            self.dec.unused_data.startswith(b"\x1f\x8b"):
                        rest = self.dec.unused_data
                        self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
                        out.append(self.dec.decompress(rest))
                    buff = b"".join(out)
                decomp_buff = decoder.decode(buff)
                if not cut_lines:
                    yield decomp_buff
                    continue
                lines = (remained + decomp_buff).split(line_break)
                remained = lines.pop(-1)
                for line in lines:
                    yield line
            remained += decoder.decode(b"", final=True)
            if remained:
                yield remained
        finally:
            # consumers that stop early (firstn) must not leak the child
            self.close()
