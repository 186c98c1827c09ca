"""The port's native input runtime (``paddle_tpu_torch/native``) on the CPU,
test for test beside the JAX package's ``tests/test_native_io.py``:

 - recordio round trip (zlib and uncompressed chunks, records from 0 to
   100,000 bytes) and CRC corruption, through the C++ library and through
   the plain Python versions, each reading what the other wrote;
 - the bounded blocking queue: a consumer thread gets every item in order,
   a full queue times out a push, a closed queue drains then pops None;
 - ``tensor_pack`` round trip;
 - ``PrefetchReader`` native against plain (selected explicitly), every
   record once; a missing or corrupt shard raises ``IOError`` on both; an
   exhausted reader keeps raising ``StopIteration``;
 - across packages: a shard written by ``paddle_tpu.native`` reads in the
   port and the other way round, records bitwise, and the files are
   byte-identical; ``pack_batch`` gives the same bytes for the same items.

Exact comparisons throughout (bytes and arrays): no tolerance.
"""

import os
import threading

import numpy as np
import pytest

from paddle_tpu import native as ref_native
from paddle_tpu.native import tensor_pack as ref_pack
from paddle_tpu_torch import native
from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.native.tensor_pack import pack_batch, unpack_batch

PLAIN = [False, True]
PLAIN_IDS = ["native", "plain"]


@pytest.fixture(autouse=True)
def fresh_port_session():
    framework.fresh_session()
    yield


def _records():
    rng = np.random.RandomState(3)
    return [rng.bytes(n) for n in (1, 10, 1000, 100000)] + [b""]


def test_native_library_builds():
    assert native.native_available(), "the C++ native library did not build"
    assert os.path.basename(native.library_path()).startswith("native-")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


@pytest.mark.parametrize("compressor", [1, 0], ids=["zlib", "none"])
@pytest.mark.parametrize("write_plain", PLAIN, ids=PLAIN_IDS)
def test_recordio_roundtrip(tmp_path, write_plain, compressor):
    path = str(tmp_path / "t.recordio")
    recs = _records()
    with native.RecordIOWriter(path, compressor=compressor,
                               max_chunk_bytes=2048,
                               plain=write_plain) as w:
        for r in recs:
            w.write(r)
    for read_plain in PLAIN:
        with native.RecordIOScanner(path, plain=read_plain) as sc:
            assert list(sc) == recs


def test_recordio_native_and_plain_write_the_same_bytes(tmp_path):
    recs = _records()
    files = []
    for plain in PLAIN:
        path = str(tmp_path / f"w{int(plain)}.recordio")
        with native.RecordIOWriter(path, max_chunk_bytes=4096,
                                   plain=plain) as w:
            for r in recs:
                w.write(r)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]


@pytest.mark.parametrize("plain", PLAIN, ids=PLAIN_IDS)
def test_recordio_crc_detects_corruption(tmp_path, plain):
    path = str(tmp_path / "c.recordio")
    with native.RecordIOWriter(path, plain=plain) as w:
        w.write(b"hello world" * 100)
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises((IOError, OSError)):
        list(native.RecordIOScanner(path, plain=plain))


@pytest.mark.parametrize("plain", PLAIN, ids=PLAIN_IDS)
def test_blocking_queue_threads(plain):
    q = native.BlockingQueue(4, plain=plain)
    got = []

    def consumer():
        while True:
            item = q.pop()
            if item is None:
                return
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(50):
        assert q.push(f"item{i}".encode())
    q.close()
    t.join(timeout=10)
    assert got == [f"item{i}".encode() for i in range(50)]
    assert q.pop() is None  # closed and drained
    assert not q.push(b"late")  # closed


@pytest.mark.parametrize("plain", PLAIN, ids=PLAIN_IDS)
def test_blocking_queue_capacity_blocks(plain):
    q = native.BlockingQueue(2, plain=plain)
    assert q.push(b"a") and q.push(b"b")
    assert q.size() == 2
    with pytest.raises(TimeoutError):
        q.push(b"c", timeout=0.1)
    assert q.pop() == b"a"
    q.close()
    assert q.is_closed()
    assert q.pop() == b"b"  # drains after close
    assert q.pop() is None
    q.reopen()
    assert not q.is_closed() and q.size() == 0


@pytest.mark.parametrize("kind", ["writer", "scanner", "queue", "prefetch"])
def test_plain_argument_selects_the_plain_versions(tmp_path, kind):
    path = str(tmp_path / "p.ptr")
    with native.RecordIOWriter(path) as w:
        w.write(b"x")

    def lib_of(plain):
        if kind == "writer":
            obj = native.RecordIOWriter(str(tmp_path / "w.ptr"), plain=plain)
        elif kind == "scanner":
            obj = native.RecordIOScanner(path, plain=plain)
        elif kind == "queue":
            obj = native.BlockingQueue(1, plain=plain)
        else:
            obj = native.PrefetchReader([path], n_threads=1, plain=plain)
        obj.close()
        return obj._lib

    assert lib_of(True) is None
    assert lib_of(False) is not None


def test_tensor_pack_roundtrip():
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = np.arange(5, dtype=np.int64).reshape(5, 1)
    items = [(a, ()), (b, ((0, 2, 5),))]
    out = unpack_batch(pack_batch(items))
    np.testing.assert_array_equal(out[0][0], a)
    assert out[0][1] == ()
    np.testing.assert_array_equal(out[1][0], b)
    assert out[1][1] == ((0, 2, 5),)


def _items():
    rng = np.random.RandomState(5)
    return [(rng.randn(2, 3).astype(np.float32), ()),
            (rng.randint(0, 9, size=(7, 1)).astype(np.int64),
             ((0, 3, 7), (0, 1, 2, 4, 7))),
            (np.float64(2.5), None), (np.zeros((0, 4), np.float16), ())]


def test_tensor_pack_bytes_equal_the_reference():
    items = _items()
    packed = pack_batch(items)
    assert packed == ref_pack.pack_batch(items)
    for got, want in zip(unpack_batch(packed), ref_pack.unpack_batch(packed)):
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _shards(tmp_path, writer, n=3, per=40, prefix="shard"):
    paths, expected = [], set()
    for s in range(n):
        p = str(tmp_path / f"{prefix}_{s}.ptr")
        with writer(p) as w:
            for i in range(per):
                rec = f"s{s}r{i}".encode()
                w.write(rec)
                expected.add(rec)
        paths.append(p)
    return paths, expected


def test_prefetch_reader_native_and_plain(tmp_path):
    paths, expected = _shards(tmp_path, native.RecordIOWriter)
    got = sorted(native.PrefetchReader(paths, n_threads=3, capacity=8))
    assert set(got) == expected and len(got) == 120
    got_plain = sorted(native.PrefetchReader(paths, n_threads=2,
                                             plain=True))
    assert got_plain == got


@pytest.mark.parametrize("plain", PLAIN, ids=PLAIN_IDS)
def test_prefetch_reader_one_thread_keeps_file_order(tmp_path, plain):
    paths, _ = _shards(tmp_path, native.RecordIOWriter, n=2, per=30)
    got = list(native.PrefetchReader(paths, n_threads=1, capacity=4,
                                     plain=plain))
    assert got == [f"s{s}r{i}".encode() for s in range(2) for i in range(30)]


@pytest.mark.parametrize("plain", PLAIN, ids=PLAIN_IDS)
def test_prefetch_reader_error_and_exhaustion(tmp_path, plain):
    p = str(tmp_path / "ok.ptr")
    with native.RecordIOWriter(p) as w:
        for i in range(5):
            w.write(f"r{i}".encode())
    r = native.PrefetchReader([p], plain=plain)
    assert len(list(r)) == 5
    with pytest.raises(StopIteration):
        next(r)
    with pytest.raises(StopIteration):
        next(r)
    missing = str(tmp_path / "missing.ptr")
    with pytest.raises(IOError):
        list(native.PrefetchReader([p, missing], plain=plain))
    bad = str(tmp_path / "bad.ptr")
    data = bytearray(open(p, "rb").read())
    data[-2] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(native.PrefetchReader([p, bad], plain=plain))


@pytest.mark.parametrize("compressor", [1, 0], ids=["zlib", "none"])
def test_shards_cross_packages(tmp_path, compressor):
    """A shard the JAX package writes reads in the port and the other way
    round, records bitwise; both write the same bytes."""
    recs = [pack_batch(items) for items in (_items(), _items()[:2])] \
        + _records()
    ref_path = str(tmp_path / "ref.ptr")
    port_path = str(tmp_path / "port.ptr")
    for mod, path in ((ref_native, ref_path), (native, port_path)):
        with mod.RecordIOWriter(path, compressor=compressor,
                                max_chunk_bytes=4096) as w:
            for r in recs:
                w.write(r)
    assert open(ref_path, "rb").read() == open(port_path, "rb").read()
    for plain in PLAIN:
        assert list(native.RecordIOScanner(ref_path, plain=plain)) == recs
    assert list(ref_native.RecordIOScanner(port_path)) == recs
    assert sorted(native.PrefetchReader([ref_path])) == sorted(recs)
    assert sorted(ref_native.PrefetchReader([port_path])) == sorted(recs)
