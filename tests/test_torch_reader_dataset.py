"""``paddle_tpu_torch.reader`` and ``paddle_tpu_torch.dataset`` against the
JAX package's, on the CPU.

 - every reader decorator (``map_readers``, ``buffered``, ``compose``,
   ``chain``, ``shuffle`` seeded, per epoch, ``firstn``, ``cache``,
   ``batch`` with and without ``drop_last``, ``device_buffered`` on the
   CPU) and ``PipeReader`` give the reference's output on the same seeded
   readers; ``xmap_readers`` gives the reference's results, and with
   ``order=True`` in the source's order (the reference's copy ignores
   ``order``; upstream keeps it);
 - the first 64 samples of a reader of each of the dataset modules
   (their deterministic synthetic fallbacks: nothing is downloaded) equal
   the reference's, value and dtype;
 - the package exports ``reader``, ``dataset``, ``data`` and ``batch``.
"""

import sys

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import dataset as ref_ds
from paddle_tpu import reader as ref_reader
from paddle_tpu_torch import dataset as port_ds
from paddle_tpu_torch import fluid as tf
from paddle_tpu_torch import reader as port_reader

PKGS = {"ref": ref_reader, "port": port_reader}


def _src(n=20, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield (rng.normal(size=2).astype(np.float32), i)
    return reader


def _same(a, b):
    """Deep equality of samples: numpy arrays by value and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


DECORATORS = {
    "map_readers": lambda r: r.map_readers(lambda a, b: (a[0] + b[0], a[1]),
                                           _src(), _src(seed=1)),
    "buffered": lambda r: r.buffered(_src(), 4),
    "compose": lambda r: r.compose(_src(), _src(seed=2)),
    "chain": lambda r: r.chain(_src(5), _src(7, seed=3)),
    "shuffle": lambda r: r.shuffle(_src(), 6, seed=9),
    "firstn": lambda r: r.firstn(_src(), 7),
    "cache": lambda r: r.cache(_src()),
    "batch": lambda r: r.batch(_src(), 6),
    "batch_drop_last": lambda r: r.batch(_src(), 6, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorator_matches_reference(name):
    out = {}
    for pkg, mod in PKGS.items():
        reader = DECORATORS[name](mod)
        out[pkg] = [list(reader()) for _ in range(2)]  # two epochs
    assert _same(out["port"], out["ref"])
    assert out["port"][0]


@pytest.mark.parametrize("order", [True, False])
def test_xmap_readers_against_reference(order):
    """The reference's ``xmap_readers`` ignores ``order`` (its threads
    finish in any order); the port's keeps the source's order with
    ``order=True``, as upstream does.  Either way the same results."""
    def mapper(s):
        return (s[0] * 3, s[1])

    out = {pkg: list(mod.xmap_readers(mapper, _src(), 3, 4, order=order)())
           for pkg, mod in PKGS.items()}
    key = (lambda s: s[1])
    assert _same(sorted(out["port"], key=key), sorted(out["ref"], key=key))
    if order:
        assert _same(out["port"], [mapper(s) for s in _src()()])


def test_device_buffered_on_the_cpu_matches_reference():
    from paddle_tpu.reader.decorator import device_buffered as ref_db
    from paddle_tpu_torch.reader.decorator import device_buffered

    ref = [tuple(np.asarray(x) for x in s)
           for s in ref_db(_src(), size=2)()]
    port = [tuple(x.numpy() if hasattr(x, "numpy") else x for x in s)
            for s in device_buffered(_src(), size=2,
                                     place=tf.CPUPlace())()]
    assert len(port) == len(ref) == 20
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p[0], r[0])
        assert int(p[1]) == int(r[1])


def test_pipe_reader_matches_reference():
    cmd = f"{sys.executable} -c print('a\\nbb\\nccc')"
    lines = {}
    for pkg, mod in PKGS.items():
        lines[pkg] = list(mod.decorator.PipeReader(cmd).get_line())
    assert lines["port"] == lines["ref"] == ["a", "bb", "ccc"]


def _cases():
    return {
        "mnist.train": lambda d: d.mnist.train(),
        "mnist.test": lambda d: d.mnist.test(),
        "cifar.train10": lambda d: d.cifar.train10(),
        "cifar.test100": lambda d: d.cifar.test100(),
        "uci_housing.train": lambda d: d.uci_housing.train(),
        "imdb.train": lambda d: d.imdb.train(d.imdb.word_dict()),
        "imikolov.train": lambda d: d.imikolov.train(
            d.imikolov.build_dict(), 5),
        "movielens.train": lambda d: d.movielens.train(),
        "mq2007.train": lambda d: d.mq2007.train(),
        "mq2007.listwise": lambda d: d.mq2007.test(format="listwise"),
        "sentiment.train": lambda d: d.sentiment.train(),
        "voc2012.train": lambda d: d.voc2012.train(),
        "wmt14.train": lambda d: d.wmt14.train(1000),
        "wmt16.train": lambda d: d.wmt16.train(1000, 1000),
        "flowers.train": lambda d: d.flowers.train(),
        "conll05.test": lambda d: d.conll05.test(),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_dataset_first_64_samples_match_reference(case):
    make = _cases()[case]
    got = {}
    for pkg, ds in (("ref", ref_ds), ("port", port_ds)):
        samples = []
        for s in make(ds)():
            samples.append(s)
            if len(samples) == 64:
                break
        got[pkg] = samples
    assert got["port"], case
    assert _same(got["port"], got["ref"]), case


def test_dataset_helpers_match_reference():
    assert port_ds.wmt16.get_dict("en", 100) == ref_ds.wmt16.get_dict("en",
                                                                      100)
    assert port_ds.wmt14.get_dict(100) == ref_ds.wmt14.get_dict(100)
    assert port_ds.movielens.max_user_id() == ref_ds.movielens.max_user_id()
    assert port_ds.imikolov.build_dict() == ref_ds.imikolov.build_dict()
    assert port_ds.conll05.get_dict() == ref_ds.conll05.get_dict()
    assert port_ds.common.cached_path("x") == ref_ds.common.cached_path("x")
    assert sorted(port_ds.__all__) == sorted(ref_ds.__all__)


def test_package_exports():
    for name in ("reader", "dataset", "data", "batch"):
        assert hasattr(paddle_tpu_torch, name), name
    assert paddle_tpu_torch.batch is port_reader.batch
    got = list(paddle_tpu_torch.batch(_src(5), 2)())
    want = list(paddle_tpu.batch(_src(5), 2)())
    assert _same(got, want)
