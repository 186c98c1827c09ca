"""LoD through the port's Executor against the JAX package's, on the CPU:

 - ShareLoD: a LoD feed reaches ``sequence_pool`` through
   ``lookup_table``, ``mul``, ``sum`` and ``elementwise_add`` (``fc`` over
   two inputs), each intermediate fetched with ``return_numpy=False``
   carrying the reference's LoD; inputs with two different LoDs share
   none; an output whose leading dim is not the packed row count takes
   none; rebinding a name drops its LoD; an op's own LoD (``lod_reset``)
   wins over ShareLoD and passes on;
 - the plan cache keeps no batch's LoD: one executor runs two batches of
   other lengths, each as the reference does;
 - a persistable's LoD stays in the scope across runs (one Program
   writes it, another pools over it);
 - the data feeder's LoD path (the reference's
   ``tests/test_sequence_ops.py:213``), and the ``(array, lengths)``
   feed form;
 - ``run_steps`` refuses a LoD feed, in either form, as the reference
   does.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _lod(v):
    return tuple(tuple(level) for level in v.lod()) if hasattr(v, "lod") \
        else ()


def _both(build, feeds):
    """``build(pkg)`` (the fetches) in fresh Programs of each package, the
    port from the reference's initial state; one run on each of ``feeds``
    (functions of the package); returns {pkg: [fetched lists]} and each
    package's executor under ``(pkg, "exe")``."""
    out = {}
    init = None
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetches = build(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        names = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:
            init = {n: np.array(scope.get(n)) for n in names}
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        out[pkg] = [exe.run(main, feed=f(pkg), fetch_list=fetches,
                            scope=scope, return_numpy=False)
                    for f in feeds]
        out[pkg, "exe"] = exe
    return out


def _compare(out):
    for ref_run, port_run in zip(out[rf], out[tf]):
        for r, p in zip(ref_run, port_run):
            np.testing.assert_allclose(np.asarray(p), np.asarray(r), **TOL)
            assert _lod(p) == _lod(r), (_lod(p), _lod(r))


def _words(pkg, lens, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 20, size=(sum(lens), 1)).astype(np.int64)
    return {"w": pkg.create_lod_tensor(ids, [lens], pkg.CPUPlace())}


def _fc_chain(pkg):
    """embedding -> fc over two inputs (mul, mul, sum, elementwise_add)
    -> sequence_pool; every intermediate fetched."""
    w = pkg.layers.data(name="w", shape=[1], dtype="int64", lod_level=1)
    emb = pkg.layers.embedding(input=w, size=[20, 4])
    emb2 = pkg.layers.embedding(input=w, size=[20, 4])
    h = pkg.layers.fc(input=[emb, emb2], size=3)
    pooled = pkg.layers.sequence_pool(h, "max")
    block = pkg.default_main_program().global_block()
    inter = [op.output_arg_names[0] for op in block.ops
             if op.type in ("mul", "sum", "elementwise_add")]
    return [emb, emb2] + inter + [pooled]


def test_lod_reaches_sequence_pool_through_fc():
    out = _both(_fc_chain, [lambda pkg: _words(pkg, [3, 1, 4])])
    _compare(out)
    port = out[tf][0]
    types = ["lookup_table"] * 2 + ["mul", "mul", "sum", "elementwise_add"]
    assert len(port) == len(types) + 1
    for t, v in zip(types, port):
        assert _lod(v) == ((0, 3, 4, 8),), t
    assert _lod(port[-1]) == () and np.asarray(port[-1]).shape == (3, 3)


def test_plan_cache_keeps_no_batch_lod():
    out = _both(_fc_chain, [lambda pkg: _words(pkg, [3, 1, 4]),
                            lambda pkg: _words(pkg, [2, 5], seed=1),
                            lambda pkg: _words(pkg, [3, 1, 4])])
    _compare(out)
    main_plans = [k for k in out[tf, "exe"]._plans if k[2] == ("w",)]
    assert len(main_plans) == 1
    assert _lod(out[tf][1][0]) == ((0, 2, 7),)


def _two_lods(pkg):
    a = pkg.layers.data(name="a", shape=[2], dtype="float32", lod_level=1)
    b = pkg.layers.data(name="b", shape=[2], dtype="float32", lod_level=1)
    c = pkg.layers.data(name="c", shape=[2], dtype="float32")
    same = pkg.layers.elementwise_add(a, c)       # one LoD: shared
    mixed = pkg.layers.elementwise_add(a, b)      # two LoDs: none
    reduced = pkg.layers.reduce_sum(a, dim=0, keep_dim=True)  # 1 row: none
    reset = pkg.layers.lod_reset(a, target_lod=[0, 1, 5])  # the op's own
    after = pkg.layers.scale(reset, scale=2.0)   # shares the op's LoD
    return [same, mixed, reduced, reset, after]


def _two_lods_feed(pkg):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((5, 2)).astype(np.float32)
    return {"a": pkg.create_lod_tensor(x, [[2, 3]]),
            "b": (x + 1, [[4, 1]]),
            "c": x * 2}


def test_share_lod_rule():
    out = _both(_two_lods, [_two_lods_feed])
    _compare(out)
    same, mixed, reduced, reset, after = out[tf][0]
    assert _lod(same) == ((0, 2, 5),)
    assert _lod(mixed) == () and _lod(reduced) == ()
    assert _lod(reset) == _lod(after) == ((0, 1, 5),)


def test_rebinding_drops_the_lod():
    """A name written again by an op whose inputs carry no LoD loses the
    LoD its first writer gave it."""
    def build(pkg):
        block = pkg.default_main_program().global_block()
        a = pkg.layers.data(name="a", shape=[2], dtype="float32",
                            lod_level=1)
        c = pkg.layers.data(name="c", shape=[2], dtype="float32")
        v = block.create_var(name="v", shape=(-1, 2), dtype="float32")
        block.append_op(type="scale", inputs={"X": [a]},
                        outputs={"Out": [v]}, attrs={"scale": 1.0})
        first = pkg.layers.scale(v, scale=3.0)
        block.append_op(type="scale", inputs={"X": [c]},
                        outputs={"Out": [v]}, attrs={"scale": 1.0})
        return [first, v]

    out = _both(build, [_two_lods_feed])
    _compare(out)
    first, v = out[tf][0]
    assert _lod(first) == ((0, 2, 5),) and _lod(v) == ()


def test_persistable_lod_stays_in_the_scope():
    """One Program writes a persistable from a LoD feed; another,
    run later on the same scope without that feed, pools over it."""
    results = {}
    for pkg in (rf, tf):
        write, pool, startup = pkg.Program(), pkg.Program(), pkg.Program()
        with pkg.program_guard(write, startup):
            x = pkg.layers.data(name="x", shape=[2], dtype="float32",
                                lod_level=1)
            keep = pkg.default_main_program().global_block().create_var(
                name="kept", shape=(-1, 2), dtype="float32",
                persistable=True)
            pkg.default_main_program().global_block().append_op(
                type="scale", inputs={"X": [x]}, outputs={"Out": [keep]},
                attrs={"scale": 1.0})
        with pkg.program_guard(pool, startup):
            kept = pkg.default_main_program().global_block().create_var(
                name="kept", shape=(-1, 2), dtype="float32",
                persistable=True)
            pooled = pkg.layers.sequence_pool(kept, "sum")
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        x = np.arange(10, dtype=np.float32).reshape(5, 2)
        exe.run(write, feed={"x": pkg.create_lod_tensor(x, [[1, 4]])},
                scope=scope)
        assert scope._lods["kept"] == ((0, 1, 5),)
        results[pkg] = exe.run(pool, fetch_list=[pooled], scope=scope)[0]
    np.testing.assert_allclose(results[tf], results[rf], **TOL)
    np.testing.assert_allclose(results[tf], [[0, 1], [20, 24]])


def test_data_feeder_lod_path():
    """The reference's ``test_data_feeder_lod_path`` on both packages."""
    res = {}
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            words = pkg.layers.data(name="w", shape=[1], dtype="int64",
                                    lod_level=1)
            pooled = pkg.layers.sequence_pool(words, "sum")
            feeder = pkg.DataFeeder(feed_list=[words], place=pkg.CPUPlace())
        feed = feeder.feed([([1, 2, 3],), ([10, 20],)])
        assert isinstance(feed["w"], pkg.LoDTensor)
        assert feed["w"].recursive_sequence_lengths() == [[3, 2]]
        assert feed["w"].lod() == ((0, 3, 5),)
        exe = pkg.Executor(pkg.CPUPlace())
        res[pkg] = exe.run(main, feed=feed, fetch_list=[pooled],
                           scope=pkg.Scope())[0]
    np.testing.assert_allclose(res[tf].ravel(), [6, 30])
    np.testing.assert_array_equal(res[tf], res[rf])


@pytest.mark.parametrize("form", ["lod_tensor", "lengths_tuple"])
def test_run_steps_refuses_a_lod_feed(form):
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            w = pkg.layers.data(name="w", shape=[1], dtype="int64",
                                lod_level=1)
            emb = pkg.layers.embedding(input=w, size=[20, 4])
            loss = pkg.layers.mean(pkg.layers.sequence_pool(emb, "sum"))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        ids = np.arange(5, dtype=np.int64).reshape(5, 1)
        feed = pkg.create_lod_tensor(ids, [[2, 3]]) \
            if form == "lod_tensor" else (ids, [[2, 3]])
        with pytest.raises(RuntimeError, match="LoD feeds"):
            exe.run_steps(main, feed={"w": feed}, fetch_list=[loss],
                          n_steps=2, scope=scope)
