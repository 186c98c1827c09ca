"""``fluid.metrics``, ``fluid.evaluator`` and the scope-tensor API of the
port against the JAX package's, on the CPU:

 - every ``fluid.metrics`` class (``Accuracy``, ``Precision``,
   ``Recall``, ``ChunkEvaluator``, ``EditDistance``, ``Auc``,
   ``CompositeMetric``, ``DetectionMAP``) gives the reference's values on
   the same numpy-seeded inputs (the port's fed as torch tensors), before
   and after ``reset``;
 - ``fluid.evaluator``'s ``ChunkEvaluator``, ``EditDistance`` and
   ``Accuracy`` over three batches, then ``reset`` and one more batch,
   give the reference's results (rtol 1e-6), their states persistable
   vars of the scope;
 - the scope-tensor API (``Scope.var`` / ``find_var``, ``get_tensor()``:
   ``np.array(t)``, ``set``, ``shape``, the LoD and the recursive
   lengths) behaves as the reference's: a var made by ``var`` and never
   set faults on read, ``set`` writes in place where shape and dtype
   match (the tensor object stays) and stores a new tensor otherwise, and
   ``global_scope().find_var(name).get_tensor().set(...)`` feeds a
   program's parameter.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _metric_runs(pkg, to_port):
    """Each metric class fed the same batches: (name, eval before reset,
    eval after reset and one more batch)."""
    rng = np.random.RandomState(4)
    m = pkg.metrics
    batches = [dict(
        acc=(rng.rand(1).astype(np.float32), int(rng.randint(1, 9))),
        preds=rng.rand(12, 1).astype(np.float32),
        labels=rng.randint(0, 2, (12, 1)).astype(np.int64),
        chunks=[np.array([rng.randint(0, 9)], np.int64) for _ in range(3)],
        dist=(rng.randint(0, 3, (5, 1)).astype(np.float32),
              np.array([5], np.int64)),
        probs=np.concatenate([1 - (p := rng.rand(12, 1)), p], 1).astype(
            np.float32)) for _ in range(4)]
    cv = to_port if pkg is tf else (lambda a: a)
    metrics = {
        "accuracy": (m.Accuracy(), lambda b: (cv(b["acc"][0]), b["acc"][1])),
        "precision": (m.Precision(), lambda b: (cv(b["preds"]),
                                                cv(b["labels"]))),
        "recall": (m.Recall(), lambda b: (cv(b["preds"]), cv(b["labels"]))),
        "chunk": (m.ChunkEvaluator(), lambda b: [cv(c) for c in b["chunks"]]),
        "edit_distance": (m.EditDistance(),
                          lambda b: (cv(b["dist"][0]), cv(b["dist"][1]))),
        "auc": (m.Auc(num_thresholds=63),
                lambda b: (cv(b["probs"]), cv(b["labels"]))),
    }
    comp = m.CompositeMetric()
    comp.add_metric(m.Precision())
    comp.add_metric(m.Recall())
    metrics["composite"] = (comp, lambda b: (cv(b["preds"]),
                                             cv(b["labels"])))
    dmap = m.DetectionMAP()
    metrics["detection_map"] = (dmap, lambda b: (b["acc"][0], None))
    out = []
    for name, (metric, args) in sorted(metrics.items()):
        for b in batches[:3]:
            metric.update(*args(b))
        first = metric.eval()
        metric.reset()
        metric.update(*args(batches[3]))
        out.append((name, first, metric.eval()))
    return out


def test_metrics_match_reference():
    ref = _metric_runs(rf, None)
    port = _metric_runs(tf, torch.from_numpy)
    assert [r[0] for r in ref] == [p[0] for p in port]
    for (name, r1, r2), (_, p1, p2) in zip(ref, port):
        for r, p in ((r1, p1), (r2, p2)):
            np.testing.assert_allclose(np.asarray(p, np.float64),
                                       np.asarray(r, np.float64),
                                       rtol=1e-12, err_msg=name)


def _evaluator_program(pkg, kind):
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if kind == "accuracy":
            x = layers.data(name="x", shape=[5], dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="int64")
            ev = pkg.evaluator.Accuracy(input=x, label=y, k=2)
        else:
            a = layers.data(name="a", shape=[1], dtype="int64", lod_level=1)
            b = layers.data(name="b", shape=[1], dtype="int64", lod_level=1)
            ev = pkg.evaluator.ChunkEvaluator(
                input=a, label=b, chunk_scheme="IOB", num_chunk_types=2) \
                if kind == "chunk" else \
                pkg.evaluator.EditDistance(input=a, label=b)
    return main, startup, ev


def _evaluator_feeds(kind):
    rng = np.random.RandomState({"accuracy": 0, "chunk": 1, "edit": 2}[kind])
    feeds = []
    for _ in range(4):
        if kind == "accuracy":
            feeds.append({"x": rng.rand(6, 5).astype(np.float32),
                          "y": rng.randint(0, 5, (6, 1)).astype(np.int64)})
            continue
        lens = [int(v) for v in rng.randint(1, 7, 3)]
        hi = 5 if kind == "chunk" else 4
        lens_b = lens if kind == "chunk" else \
            [int(v) for v in rng.randint(0, 6, 3)]
        feeds.append({
            "a": (rng.randint(0, hi, (sum(lens), 1)).astype(np.int64),
                  [lens]),
            "b": (rng.randint(0, hi, (sum(lens_b), 1)).astype(np.int64),
                  [lens_b])})
    return feeds


@pytest.mark.parametrize("kind", ["accuracy", "chunk", "edit"])
def test_evaluator_matches_reference(kind):
    results = {}
    for pkg in (rf, tf):
        main, startup, ev = _evaluator_program(pkg, kind)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        feeds = _evaluator_feeds(kind)
        with pkg.scope_guard(scope):
            exe.run(startup)
            batch = [np.asarray(v) for v in
                     exe.run(main, feed=feeds[0], fetch_list=ev.metrics)]
            for f in feeds[1:3]:
                exe.run(main, feed=f, fetch_list=ev.metrics)
            first = ev.eval(exe)
            ev.reset(exe)
            zeros = [np.asarray(scope.get(s.name)) for s in ev.states]
            exe.run(main, feed=feeds[3], fetch_list=ev.metrics)
            second = ev.eval(exe)
        results[pkg] = (batch, first, zeros, second)
    for r, p in zip(results[rf], results[tf]):
        for rv, pv in zip(r, p):
            np.testing.assert_allclose(np.asarray(pv), np.asarray(rv),
                                       rtol=1e-6)
    assert all((z == 0).all() for z in results[tf][2])
    assert np.asarray(results[tf][1][0]).size == 1


def test_scope_var_faults_until_set():
    for pkg in (rf, tf):
        scope = pkg.Scope()
        t = scope.var("w").get_tensor()
        with pytest.raises(ValueError, match="holds no tensor"):
            np.array(t)
        with pytest.raises(ValueError):
            t.shape
        assert scope.find_var("nope") is None
        assert scope.find_var("w") is not None
    # the port's executor never reads an unset var as a value
    assert tf.Scope().get("w") is None
    scope = tf.Scope()
    scope.var("w")
    assert scope.get("w") is None


def test_scope_tensor_set_read_shape_lod():
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = {}
    for pkg in (rf, tf):
        scope = pkg.Scope()
        t = scope.var("w").get_tensor()
        t.set(arr, pkg.CPUPlace())
        t.set_recursive_sequence_lengths([[1, 3]])
        v = scope.find_var("w").get_tensor()
        got[pkg] = (np.array(v), v.shape, v.recursive_sequence_lengths(),
                    tuple(tuple(level) for level in v.lod()))
        v.set_lod([[0, 2, 4]])
        got[pkg] += (v.recursive_sequence_lengths(),)
    np.testing.assert_array_equal(got[tf][0], got[rf][0])
    assert got[tf][1:] == got[rf][1:]
    assert got[tf][1] == (4, 3)
    assert got[tf][2] == [[1, 3]] and got[tf][4] == [[2, 2]]


def test_scope_tensor_set_in_place_where_it_fits():
    scope = tf.Scope()
    held = torch.zeros(3, 2)
    scope.set("w", held)
    t = scope.find_var("w").get_tensor()
    t.set(np.ones((3, 2), np.float32), tf.CPUPlace())
    assert scope.get("w") is held and bool((held == 1).all())
    # another shape or dtype: a new tensor, the held one untouched
    t.set(np.full((2, 2), 5.0, np.float32), tf.CPUPlace())
    assert scope.get("w") is not held and tuple(scope.get("w").shape) == \
        (2, 2) and bool((held == 1).all())
    t.set(np.zeros((2, 2), np.float64))
    assert scope.get("w").dtype == torch.float64


def test_global_scope_set_feeds_a_parameter():
    """The book's embedding load: ``global_scope().find_var('emb')
    .get_tensor().set(...)`` after the startup program, then a run reads
    the loaded rows in both packages."""
    table = np.random.RandomState(0).rand(7, 4).astype(np.float32)
    ids = np.array([[3], [0], [6]], np.int64)
    out = {}
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[1], dtype="int64")
            emb = pkg.layers.embedding(
                input=x, size=[7, 4],
                param_attr=pkg.ParamAttr(name="emb", trainable=False))
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        pkg.global_scope().find_var("emb").get_tensor().set(
            table, pkg.CPUPlace())
        (out[pkg],) = exe.run(main, feed={"x": ids}, fetch_list=[emb])
    np.testing.assert_array_equal(out[tf], table[ids[:, 0]])
    np.testing.assert_array_equal(out[tf], out[rf])
