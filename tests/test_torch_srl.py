"""The book's label-semantic-roles tagger (chapter 7: ``db_lstm`` trained
through ``linear_chain_crf``, decoded by ``crf_decoding`` and scored by
``chunk_eval``) in the port against the JAX package, on the CPU, with
``chip_smoke.db_lstm`` building the same program in both packages:

 - at the book's widths (word_dim 32, hidden 512, depth 8) the port
   builds the reference's Program: the same op types in order in the
   main, startup and test programs, and the same parameters (names,
   shapes, trainability);
 - at hidden 32, depth 3, from the reference's initial scope (the
   synthetic embedding file loaded through ``find_var('emb').get_tensor()
   .set(...)`` in both packages, then ``load_reference_params``), 5 SGD
   steps on the synthetic conll05: the losses within rtol 1e-5 at step 0
   and 1e-4 after; ``emb`` (not trainable) stays bitwise; then, from the
   reference's trained state, the test program's Viterbi paths and chunk
   counts equal the reference's, and ``fluid.metrics.ChunkEvaluator``
   gives the reference's precision, recall and F1;
 - the tagger of ``tests/test_book.py:348`` trains its 25 SGD steps in
   both packages within the same tolerances, its loss falls, and its
   ``crf_decoding`` paths equal the reference's.
Also: the port's copy of the synthetic conll05 yields the reference's
samples, dictionaries and embedding file.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.dataset import conll05 as ref_conll05
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

STEPS = 5
LOSS_RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))
DICTS = [len(d) for d in conll05.get_dict()]


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _params(prog):
    return [(p.name, tuple(p.shape), p.trainable)
            for p in prog.global_block().all_parameters()]


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def test_conll05_copy_matches_reference(tmp_path, monkeypatch):
    from paddle_tpu_torch.dataset import common

    assert conll05.get_dict() == ref_conll05.get_dict()
    for a, b in zip(conll05.test()(), ref_conll05.test()()):
        assert a == b
    # the port writes its own embedding file, byte for byte the reference's
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    path = conll05.get_embedding()
    assert path.startswith(str(tmp_path))
    with open(path, "rb") as f, open(ref_conll05.get_embedding(), "rb") as g:
        assert f.read() == g.read()


def test_same_program_at_book_width():
    ref = chip_smoke.db_lstm(rf, *DICTS)
    port = chip_smoke.db_lstm(tf, *DICTS)
    for key in ("main", "startup", "test"):
        assert _types(port[key]) == _types(ref[key]), key
    assert _params(port["main"]) == _params(ref["main"])
    types = _types(port["main"])
    assert types.count("dynamic_lstm") == chip_smoke.SRL_DEPTH
    assert types.count("lookup_table") == 8
    assert types.count("linear_chain_crf") == 1
    assert types[-2:] == ["crf_decoding", "chunk_eval"]
    # emb is shared by the six word inputs and gets no grad or update
    assert not any(op.type == "sgd" and "emb" in op.input("Param")
                   for op in port["main"].global_block().ops)
    params = dict((n, (s, t)) for n, s, t in _params(port["main"]))
    assert params["emb"] == ((DICTS[0], 32), False)
    assert params["crfw"] == ((DICTS[2] + 2, DICTS[2]), True)
    assert port["main"].global_block().var("crfw").optimize_attr == \
        {"learning_rate": chip_smoke.SRL_MIX_LR}


def _snapshot(scope, startup):
    return {v.name: np.array(scope.get(v.name)).copy()
            for v in startup.list_vars() if v.persistable}


def _load_embedding(pkg, scope):
    emb = chip_smoke.load_parameter(conll05.get_embedding(), DICTS[0], 32)
    scope.find_var("emb").get_tensor().set(emb, pkg.CPUPlace())
    return emb


def _fetch(out):
    return [np.asarray(v) for v in out]


def test_small_trajectory_and_decode_match_reference():
    batches = chip_smoke.srl_batches(3)
    feeds = [chip_smoke.srl_feed(b) for b in batches]
    progs, scopes, losses = {}, {}, {}
    init = None
    for pkg in (rf, tf):
        progs[pkg] = chip_smoke.db_lstm(pkg, *DICTS, **chip_smoke.SRL_SMALL)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(progs[pkg]["startup"], scope=scope)
        emb = _load_embedding(pkg, scope)
        if init is None:
            init = _snapshot(scope, progs[pkg]["startup"])
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        losses[pkg] = np.array([float(np.asarray(exe.run(
            progs[pkg]["main"], feed=feeds[k % 2],
            fetch_list=[progs[pkg]["cost"]], scope=scope)[0]).reshape(-1)[0])
            for k in range(STEPS)])
        scopes[pkg] = (exe, scope)
    np.testing.assert_array_less(
        np.abs(losses[tf] - losses[rf]) / np.abs(losses[rf]), LOSS_RTOL)
    assert losses[tf][-1] < losses[tf][0]
    np.testing.assert_array_equal(
        np.asarray(scopes[tf][1].get("emb")), emb)

    # decode from the reference's trained state in both packages
    trained = _snapshot(scopes[rf][1], progs[rf]["startup"])
    load_reference_params(scopes[tf][1], trained, tf.CPUPlace())
    got = {}
    for pkg in (rf, tf):
        exe, scope = scopes[pkg]
        p = progs[pkg]
        metric = pkg.metrics.ChunkEvaluator()
        outs = []
        for f in feeds:
            out = _fetch(exe.run(p["test"], feed=f, fetch_list=[
                p["decode"], *p["chunk"]], scope=scope))
            metric.update(*out[4:])
            outs.append(out)
        got[pkg] = (outs, metric.eval())
    for r, t in zip(got[rf][0], got[tf][0]):
        np.testing.assert_array_equal(t[0], r[0])          # Viterbi path
        assert t[0].dtype == np.int64
        for rv, tv in zip(r[4:], t[4:]):                     # chunk counts
            np.testing.assert_array_equal(tv, rv)
            assert tv.dtype == rv.dtype == np.int64
        np.testing.assert_allclose(np.concatenate(t[1:4]),
                                   np.concatenate(r[1:4]), rtol=1e-6)
    np.testing.assert_allclose(got[tf][1], got[rf][1], rtol=1e-12)


def _book_tagger(pkg):
    """``tests/test_book.py:348``'s network in ``pkg``."""
    layers = pkg.layers
    pkg.default_startup_program().random_seed = 9
    word_d, verb_d, label_d = DICTS

    def data(name):
        return layers.data(name=name, shape=[1], dtype="int64", lod_level=1)

    word, verb, mark, target = (data(n) for n in
                                ("word", "verb", "mark", "target"))
    embs = [layers.embedding(input=word, size=[word_d, 16]),
            layers.embedding(input=verb, size=[verb_d, 16]),
            layers.embedding(input=mark, size=[2, 16])]
    h = layers.fc(input=layers.concat(input=embs, axis=1), size=32,
                  act="tanh")
    emission = layers.fc(input=h, size=label_d)
    loss = layers.mean(layers.linear_chain_crf(
        emission, target, param_attr=pkg.ParamAttr(name="crfw")))
    pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    decode = layers.crf_decoding(emission,
                                 param_attr=pkg.ParamAttr(name="crfw"))
    return loss, decode


def _book_feed(samples):
    lens = [len(s[0]) for s in samples]

    def cat(idx):
        return (np.concatenate([np.asarray(s[idx], np.int64)
                                for s in samples]).reshape(-1, 1), [lens])
    return {"word": cat(0), "verb": cat(6), "mark": cat(7),
            "target": cat(8)}


def test_book_tagger_trains_as_reference():
    batches = chip_smoke.srl_batches(25, batch=8)
    probe = _book_feed(chip_smoke.srl_batches(1, batch=2)[0])
    losses, paths, init, trained = {}, {}, None, None
    for pkg in (rf, tf):
        loss, decode = _book_tagger(pkg)
        main, startup = pkg.default_main_program(), \
            pkg.default_startup_program()
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = _snapshot(scope, startup)
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        losses[pkg] = np.array([float(np.asarray(exe.run(
            main, feed=_book_feed(b), fetch_list=[loss],
            scope=scope)[0]).reshape(-1)[0]) for b in batches])
        # decode from the reference's trained weights in both packages
        if trained is None:
            trained = _snapshot(scope, startup)
        else:
            load_reference_params(scope, trained, tf.CPUPlace())
        paths[pkg] = np.asarray(exe.run(
            main.clone(for_test=True), feed=probe, fetch_list=[decode],
            scope=scope)[0])
    tol = np.array([1e-5] + [1e-4] * (len(batches) - 1))
    np.testing.assert_array_less(
        np.abs(losses[tf] - losses[rf]) / np.abs(losses[rf]), tol)
    assert losses[tf][-1] < losses[tf][0]
    np.testing.assert_array_equal(paths[tf], paths[rf])
    assert paths[tf].shape == (sum(probe["word"][1][0]), 1)
