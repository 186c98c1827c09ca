"""Native runtime of the input side: recordio shards, the bounded byte
queue and the multi-threaded shard prefetcher, in C++ loaded with ctypes
(counterpart of ``paddle_tpu/native``).

``recordio.cc``, ``blocking_queue.cc`` and ``prefetch.cc`` are built with
``g++`` into ``build/paddle_tpu_torch/native-<hash>.so`` under the checkout
at first use, never when a module is imported; the hash covers the sources,
the compiler and the flags, so an edited source rebuilds and an unchanged
one loads at once.  Several processes may build at once: each writes a
file of its own and moves it into place.

A failed build raises: the port never switches to Python on its own.  The
Python versions of the writer, the scanner, the queue and the prefetcher
are the plain versions the tests hold the library against; a caller
selects them explicitly, per object, with ``plain=True``.  The on-disk
format (PTR1 chunks) and the record packing (``tensor_pack``) are the JAX
package's byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue as _pyqueue
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, name) for name in
                ("recordio.cc", "blocking_queue.cc", "prefetch.cc"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "paddle_tpu_torch")
#: the compiler; a test points it elsewhere to check that a failed build
#: raises
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: ``-lz`` needs zlib's development link; the runtime ``libz.so.1`` by
#: name where it is missing
LIBS = ("-lz", "-lpthread")
LIBS_RUNTIME_ZLIB = ("-l:libz.so.1", "-lpthread")

_lib = None
_lib_lock = threading.Lock()
#: seconds the last build of this process took (None: loaded as built)
build_seconds: Optional[float] = None


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    log = ""
    for libs in (LIBS, LIBS_RUNTIME_ZLIB):
        cmd = [CXX, *CXX_FLAGS, *SOURCES, "-o", tmp, *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"native: cannot run the compiler "
                               f"{CXX!r}: {exc}") from exc
        log += proc.stdout + proc.stderr
        if proc.returncode == 0 or "-lz" not in proc.stderr:
            break  # built, or failed for another reason than zlib's link
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError(f"native: {CXX} failed to build "
                           f"paddle_tpu_torch/native:\n{log}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def _bind(lib):
    lib.pt_recordio_writer_open.restype = ctypes.c_void_p
    lib.pt_recordio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            ctypes.c_long]
    lib.pt_recordio_write.restype = ctypes.c_int
    lib.pt_recordio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_long]
    lib.pt_recordio_writer_close.restype = ctypes.c_int
    lib.pt_recordio_writer_close.argtypes = [ctypes.c_void_p]
    lib.pt_recordio_scanner_open.restype = ctypes.c_void_p
    lib.pt_recordio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.pt_recordio_next.restype = ctypes.c_long
    lib.pt_recordio_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_char_p)]
    lib.pt_recordio_scanner_close.argtypes = [ctypes.c_void_p]
    lib.pt_free.argtypes = [ctypes.c_char_p]
    lib.pt_queue_create.restype = ctypes.c_void_p
    lib.pt_queue_create.argtypes = [ctypes.c_long]
    lib.pt_queue_push.restype = ctypes.c_int
    lib.pt_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_double]
    lib.pt_queue_pop.restype = ctypes.c_long
    lib.pt_queue_pop.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_double]
    for name in ("pt_queue_close", "pt_queue_destroy", "pt_queue_reopen"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.pt_queue_is_closed.restype = ctypes.c_int
    lib.pt_queue_is_closed.argtypes = [ctypes.c_void_p]
    lib.pt_queue_size.restype = ctypes.c_long
    lib.pt_queue_size.argtypes = [ctypes.c_void_p]
    lib.pt_prefetch_create.restype = ctypes.c_void_p
    lib.pt_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_long]
    lib.pt_prefetch_next.restype = ctypes.c_long
    lib.pt_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_double]
    lib.pt_prefetch_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The loaded library, built first if it has no current build; raises
    when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            out = library_path()
            if not os.path.exists(out):
                _compile(out)
            _lib = _bind(ctypes.CDLL(out))
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (a query: the readers
    themselves raise on a failed build)."""
    try:
        get_lib()
        return True
    except (RuntimeError, OSError):
        return False


def _resolve(plain: bool):
    """The library, or None for an object that runs its plain version."""
    return None if plain else get_lib()


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------

_MAGIC = 0x50545231  # "PTR1"


class RecordIOWriter:
    """Writes records into PTR1 chunks (upstream's recordio/writer.h)."""

    def __init__(self, path: str, compressor: int = 1,
                 max_chunk_bytes: int = 1 << 20, plain: bool = False):
        self._lib = _resolve(plain)
        self._path = path
        if self._lib:
            self._h = self._lib.pt_recordio_writer_open(
                path.encode(), int(bool(compressor)), max_chunk_bytes)
            if not self._h:
                raise IOError(f"cannot open {path} for writing")
        else:
            import zlib

            self._zlib = zlib
            self._f = open(path, "wb")
            self._compressor = int(bool(compressor))
            self._pending = []
            self._pending_bytes = 0
            self._max = max_chunk_bytes

    def write(self, record: bytes):
        if isinstance(record, str):
            record = record.encode()
        if self._lib:
            if self._lib.pt_recordio_write(self._h, record,
                                           len(record)) != 0:
                raise IOError("recordio write failed")
            return
        self._pending.append(bytes(record))
        self._pending_bytes += len(record)
        if self._pending_bytes >= self._max:
            self._flush_py()

    def _flush_py(self):
        import struct

        if not self._pending:
            return
        raw = b"".join(struct.pack("<Q", len(r)) + r for r in self._pending)
        stored = self._zlib.compress(raw, 1) if self._compressor else raw
        crc = self._zlib.crc32(stored) & 0xFFFFFFFF
        self._f.write(struct.pack("<IIIQQI", _MAGIC, self._compressor,
                                  len(self._pending), len(raw), len(stored),
                                  crc))
        self._f.write(stored)
        self._pending, self._pending_bytes = [], 0

    def close(self):
        if self._lib:
            if self._h is not None:
                h, self._h = self._h, None
                if self._lib.pt_recordio_writer_close(h) != 0:
                    raise IOError("recordio close failed")
        elif not self._f.closed:
            self._flush_py()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class RecordIOScanner:
    """Iterates the records of a PTR1 file (upstream's recordio/scanner.h);
    a corrupt chunk raises ``IOError``."""

    def __init__(self, path: str, plain: bool = False):
        self._lib = _resolve(plain)
        self._path = path
        if self._lib:
            self._h = self._lib.pt_recordio_scanner_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "rb")
            self._chunk = []
            self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._lib:
            if self._h is None:
                raise StopIteration
            out = ctypes.c_char_p()
            n = self._lib.pt_recordio_next(self._h, ctypes.byref(out))
            if n == -1:
                raise StopIteration
            if n == -2:
                raise IOError(f"corrupt recordio file {self._path}")
            data = ctypes.string_at(out, n)
            self._lib.pt_free(out)
            return data
        return self._next_py()

    def _next_py(self) -> bytes:
        import struct
        import zlib

        if self._cursor >= len(self._chunk):
            head = self._f.read(32)
            if not head:
                raise StopIteration
            if len(head) < 32:
                raise IOError("corrupt recordio header")
            magic, comp, n, raw_len, stored_len, crc = struct.unpack(
                "<IIIQQI", head)
            if magic != _MAGIC:
                raise IOError("bad recordio magic")
            stored = self._f.read(stored_len)
            if (zlib.crc32(stored) & 0xFFFFFFFF) != crc:
                raise IOError("recordio crc mismatch")
            raw = zlib.decompress(stored) if comp else stored
            self._chunk, self._cursor, pos = [], 0, 0
            for _ in range(n):
                (ln,) = struct.unpack_from("<Q", raw, pos)
                pos += 8
                self._chunk.append(raw[pos: pos + ln])
                pos += ln
        rec = self._chunk[self._cursor]
        self._cursor += 1
        return rec

    def close(self):
        if self._lib:
            if self._h:
                self._lib.pt_recordio_scanner_close(self._h)
                self._h = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Blocking queue
# ---------------------------------------------------------------------------


class BlockingQueue:
    """Bounded byte-payload queue (upstream's LoDTensorBlockingQueue):
    ``close()`` wakes every waiter; pops drain what is left after it."""

    def __init__(self, capacity: int, plain: bool = False):
        self._lib = _resolve(plain)
        self.capacity = capacity
        if self._lib:
            self._h = self._lib.pt_queue_create(capacity)
        else:
            self._q = _pyqueue.Queue(maxsize=capacity)
            self._closed = False

    def push(self, data: bytes, timeout: float = -1.0) -> bool:
        """False iff the queue is closed."""
        if self._lib:
            r = self._lib.pt_queue_push(self._h, data, len(data), timeout)
            if r == -2:
                raise TimeoutError("queue push timed out")
            return r == 0
        # poll, so that close() wakes a blocked producer
        deadline = None if timeout < 0 else time.monotonic() + timeout
        while True:
            if self._closed:
                return False
            try:
                self._q.put(data, timeout=0.05)
                return True
            except _pyqueue.Full:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("queue push timed out") from None

    def pop(self, timeout: float = -1.0):
        """bytes, or None when closed and drained."""
        if self._lib:
            out = ctypes.c_char_p()
            n = self._lib.pt_queue_pop(self._h, ctypes.byref(out), timeout)
            if n == -1:
                return None
            if n == -2:
                raise TimeoutError("queue pop timed out")
            data = ctypes.string_at(out, n)
            self._lib.pt_free(out)
            return data
        while True:
            try:
                return self._q.get(timeout=0.05 if timeout < 0 else timeout)
            except _pyqueue.Empty:
                if self._closed:
                    return None
                if timeout >= 0:
                    raise TimeoutError("queue pop timed out") from None

    def close(self):
        if self._lib:
            self._lib.pt_queue_close(self._h)
        else:
            self._closed = True

    def reopen(self):
        if self._lib:
            self._lib.pt_queue_reopen(self._h)
        else:
            self._q = _pyqueue.Queue(maxsize=self.capacity)
            self._closed = False

    def is_closed(self) -> bool:
        if self._lib:
            return bool(self._lib.pt_queue_is_closed(self._h))
        return self._closed

    def size(self) -> int:
        if self._lib:
            return self._lib.pt_queue_size(self._h)
        return self._q.qsize()

    def __del__(self):
        try:
            if self._lib and self._h:
                self._lib.pt_queue_destroy(self._h)
                self._h = None
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Shard prefetcher
# ---------------------------------------------------------------------------


class PrefetchReader:
    """Yields the records of recordio shards, read ahead by ``n_threads``
    C++ threads into a buffer of ``capacity`` records (upstream's
    open_files reader, operators/reader/open_files_op.cc).  Shards are
    dealt round-robin to the threads, so with one thread the records come
    in file order.  An unopenable or corrupt shard raises ``IOError`` once
    the records already buffered are drained.  The plain version runs
    Python threads over the plain scanner and queue."""

    def __init__(self, paths, n_threads: int = 2, capacity: int = 256,
                 plain: bool = False):
        self._paths = [os.fspath(p) for p in paths]
        self._lib = _resolve(plain)
        self._h = None
        self._done = False
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths])
            self._h = ctypes.c_void_p(self._lib.pt_prefetch_create(
                arr, len(self._paths), int(n_threads), int(capacity)))
            return
        # plain: Python threads over the plain queue; a push that returns
        # False after close() stops an abandoned worker
        self._q = BlockingQueue(capacity, plain=True)
        self._errors: list = []
        n = max(1, min(int(n_threads), len(self._paths) or 1))
        self._live_left = n
        self._live_lock = threading.Lock()

        def work(start):
            try:
                for i in range(start, len(self._paths), n):
                    for rec in RecordIOScanner(self._paths[i], plain=True):
                        if not self._q.push(rec):
                            return  # the reader was closed early
            except Exception as exc:  # raised in the consumer
                self._errors.append(exc)
            finally:
                with self._live_lock:
                    self._live_left -= 1
                    if self._live_left == 0:
                        self._q.close()

        for t in range(n):
            threading.Thread(target=work, args=(t,), daemon=True).start()

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._done:
            raise StopIteration
        if self._lib is not None:
            out = ctypes.c_char_p()
            n = self._lib.pt_prefetch_next(
                self._h, ctypes.byref(out), ctypes.c_double(-1.0))
            if n == -3:
                self.close()
                raise IOError(
                    "PrefetchReader: a shard was unreadable or corrupt")
            if n < 0:
                self.close()
                raise StopIteration
            data = ctypes.string_at(out, n)
            self._lib.pt_free(out)
            return data
        rec = self._q.pop()
        if rec is None:  # closed and drained
            self._done = True
            if self._errors:
                raise IOError(
                    f"PrefetchReader: shard failed: {self._errors[0]!r}")
            raise StopIteration
        return rec

    def close(self):
        self._done = True
        if self._h is not None:
            self._lib.pt_prefetch_destroy(self._h)
            self._h = None
        elif self._lib is None and hasattr(self, "_q"):
            self._q.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["RecordIOWriter", "RecordIOScanner", "BlockingQueue",
           "PrefetchReader", "native_available", "get_lib"]
