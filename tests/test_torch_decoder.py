"""``fluid.contrib.decoder`` in the port against the JAX package, on the
CPU:

 - the decoder-DSL test of the reference (``tests/test_beam_search_decoder_
   dsl.py``): the same ``StateCell`` trained under ``TrainingDecoder``
   (a ``DynamicRNN``: ``while`` and ``while_grad``) with Adam for 80 steps
   from the reference's initialized scope (losses within rtol 1e-5 at step
   0 and 1e-4 after), saved with ``fluid.io.save_persistables``, loaded
   into a ``BeamSearchDecoder`` and a ``JitBeamSearchDecoder`` program of
   each package (the port's checkpoint, read by both): ids and LoDs equal,
   scores within 1e-5, and the top hypothesis of each source follows the
   learned chain (the test's targets hold no EOS, so every hypothesis
   runs to max_len: the early exit is the next case's);
 - the reference's jit cases of ``tests/test_jit_beam_search.py:141,200``
   (every beam ends at step 1; per-source context through
   ``input_var_dict``) from the reference's initial weights: the same
   output and step count;
 - ``bench.py``'s ``bench_decode`` at its widths (vocab 1000, d 64,
   batch 8, beam 4, max_len 16, topk 50, seed 5, its ``RandomState(0)``
   feed): both engines in the port give the reference's hypotheses;
 - a ``jit_beam_search`` op's engine goes with its program;
 - the three decoders build the reference's Programs.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params
from paddle_tpu_torch.ops import beam_search_jit

V, D, GO, EOS, CHAIN_LEN, STEPS = 14, 24, 2, 1, 5, 80
ATOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _decoder(fluid):
    from importlib import import_module

    return import_module(fluid.__name__ + ".contrib.decoder")


def _sig(program):
    return [(b.idx, b.parent_idx,
             [(op.type, dict(op.inputs), dict(op.outputs),
               op.attr("sub_block")) for op in b.ops])
            for b in program.blocks]


def _np(v):
    if hasattr(v, "lod") and callable(v.lod):
        return np.asarray(v), tuple(tuple(int(o) for o in lvl)
                                    for lvl in v.lod())
    if isinstance(v, torch.Tensor):
        return v.detach().numpy(), ()
    return np.asarray(v), ()


def _perm():
    rng = np.random.RandomState(77)
    body = rng.permutation(np.arange(3, V))
    return {int(a): int(b) for a, b in zip(np.arange(3, V), body)}


def _chain(start, n):
    p, seq, w = _perm(), [], start
    for _ in range(n):
        w = p[w]
        seq.append(w)
    return seq


def _cell(fluid, h_boot, d):
    dec, layers = _decoder(fluid), fluid.layers
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=h_boot,
                                                    need_reorder=True)},
                         out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", layers.fc(input=[c.get_input("x"),
                                          c.get_state("h")],
                                   size=d, act="tanh"))

    return cell


def build_train(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src", shape=[1], dtype="int64")
        h0 = layers.fc(input=layers.embedding(src, size=[V, D]), size=D,
                       act="tanh")
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        cell = _cell(fluid, h0, D)
        trg_emb = layers.embedding(trg, size=[V, D])
        dec = _decoder(fluid).TrainingDecoder(cell)
        with dec.block():
            x = dec.step_input(trg_emb)
            cell.compute_state(inputs={"x": x})
            score = layers.fc(input=cell.out_state(), size=V, act="softmax")
            cell.update_states()
            dec.output(score)
        prob = dec()
        loss = layers.mean(layers.cross_entropy(input=prob, label=lbl))
        fluid.optimizer.Adam(learning_rate=8e-3).minimize(loss)
    return main, startup, loss


def train_feed(fluid):
    starts = [3, 4, 5, 6]
    trg, lbl = [], []
    for s in starts:
        c = _chain(s, CHAIN_LEN)
        trg += [GO] + c[:-1]
        lbl += c
    lens = [[CHAIN_LEN] * len(starts)]
    return {"src": np.array([[s] for s in starts], np.int64),
            "trg": fluid.create_lod_tensor(
                np.array(trg, np.int64).reshape(-1, 1), lens),
            "lbl": fluid.create_lod_tensor(
                np.array(lbl, np.int64).reshape(-1, 1), lens)}


def build_decode(fluid, cls_name, v=V, d=D, max_len=CHAIN_LEN + 2, beam=2,
                 topk=V, seed=None):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src", shape=[1], dtype="int64")
        h0 = layers.fc(input=layers.embedding(src, size=[v, d]), size=d,
                       act="tanh")
        cell = _cell(fluid, h0, d)
        init_ids = layers.data(name="init_ids", shape=[1], dtype="int64",
                               lod_level=2)
        init_scores = layers.data(name="init_scores", shape=[1],
                                  dtype="float32", lod_level=2)
        dec = getattr(_decoder(fluid), cls_name)(
            cell, init_ids, init_scores, target_dict_dim=v, word_dim=d,
            topk_size=topk, sparse_emb=False, max_len=max_len,
            beam_size=beam, end_id=EOS)
        dec.decode()
        out_ids, out_scores = dec()
    return main, startup, out_ids, out_scores


def decode_feed(fluid, src, init=GO):
    b = len(src)
    lod2 = [[1] * b, [1] * b]
    return {"src": np.asarray(src, np.int64).reshape(b, 1),
            "init_ids": fluid.create_lod_tensor(
                np.full((b, 1), init, np.int64), lod2),
            "init_scores": fluid.create_lod_tensor(
                np.zeros((b, 1), np.float32), lod2)}


def _arrays(fluid, scope, program):
    out = {}
    for v in program.list_vars():
        if v.persistable and scope.get(v.name) is not None:
            val = scope.get(v.name)
            out[v.name] = (val.detach().numpy() if isinstance(
                val, torch.Tensor) else np.asarray(val)).copy()
    return out


def run_decode(fluid, cls_name, weights, feed, **build):
    """Decode ``feed`` with ``weights`` ({name: array}, or None for the
    startup's own): (ids, ids LoD, scores)."""
    main, startup, out_ids, out_scores = build_decode(fluid, cls_name,
                                                      **build)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.executor.Scope()
    exe.run(startup, scope=scope)
    if weights is not None:
        for name, arr in weights.items():
            if fluid is tf:
                load_reference_params(scope, {name: arr}, tf.CPUPlace())
            else:
                scope.set(name, arr)
    ids, scores = exe.run(main, feed=feed, fetch_list=[out_ids, out_scores],
                          scope=scope, return_numpy=False)
    (ids, lod), (scores, _) = _np(ids), _np(scores)
    return ids.ravel(), lod, scores.ravel(), _arrays(fluid, scope, startup)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ATOL)


def test_decoders_build_reference_programs():
    for build in (lambda f: build_train(f)[0],
                  lambda f: build_decode(f, "BeamSearchDecoder")[0],
                  lambda f: build_decode(f, "JitBeamSearchDecoder")[0]):
        assert _sig(build(tf)) == _sig(build(rf))


def test_train_save_load_decode_both_engines(tmp_path):
    rmain, rstart, rloss = build_train(rf)
    pmain, pstart, ploss = build_train(tf)
    rexe, rscope = rf.Executor(rf.CPUPlace()), rf.executor.Scope()
    rexe.run(rstart, scope=rscope)
    pexe, pscope = tf.Executor(tf.CPUPlace()), tf.Scope()
    pexe.run(pstart, scope=pscope)
    load_reference_params(pscope, {
        v.name: np.asarray(rscope.get(v.name)) for v in rstart.list_vars()
        if v.persistable}, tf.CPUPlace())
    rl, pl = [], []
    for _ in range(STEPS):
        rl.append(float(np.asarray(rexe.run(
            rmain, feed=train_feed(rf), fetch_list=[rloss],
            scope=rscope)[0]).reshape(-1)[0]))
        pl.append(float(pexe.run(pmain, feed=train_feed(tf),
                                 fetch_list=[ploss],
                                 scope=pscope)[0].reshape(-1)[0]))
    rtol = np.array([1e-5] + [1e-4] * (STEPS - 1))
    assert np.all(np.abs(np.array(pl) - rl) <= rtol * np.abs(rl)), \
        (pl[:3], rl[:3])
    assert pl[-1] < 0.15, (pl[0], pl[-1])
    with tf.scope_guard(pscope):
        tf.io.save_persistables(pexe, str(tmp_path), pmain)

    results = {}
    for pkg in (tf, rf):
        for cls_name in ("BeamSearchDecoder", "JitBeamSearchDecoder"):
            main, startup, out_ids, out_scores = build_decode(pkg, cls_name)
            exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.executor.Scope()
            exe.run(startup, scope=scope)
            with pkg.scope_guard(scope):
                pkg.io.load_persistables(exe, str(tmp_path), main)
            ids, scores = exe.run(main, feed=decode_feed(pkg, [3, 5]),
                                  fetch_list=[out_ids, out_scores],
                                  scope=scope, return_numpy=False)
            (ids, lod), (scores, _) = _np(ids), _np(scores)
            results[(pkg.__name__, cls_name)] = (ids.ravel(), lod,
                                                 scores.ravel())
    want = results[(rf.__name__, "BeamSearchDecoder")]
    for key, got in results.items():
        _same(got, want)
    ids, lod, _ = results[(tf.__name__, "JitBeamSearchDecoder")]
    src, off = lod
    for i, start in enumerate((3, 5)):
        j = src[i]
        top = ids[off[j]:off[j + 1]].tolist()
        got = [t for t in top if t not in (GO, EOS)]
        assert got[:3] == _chain(start, CHAIN_LEN)[:3]


def _jit_case(fluid, context):
    """The reference's early-exit (``context=False``) and context-var
    (``context=True``) jit programs: V 23, D 8, batch 3, beam 4, max_len
    6."""
    v, d, layers = 23, 8, fluid.layers
    dec = _decoder(fluid)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 41 if context else 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src", shape=[1], dtype="int64")
        enc = layers.fc(input=layers.embedding(src, size=[v, d]), size=d,
                        act="tanh")
        h0 = layers.fc(input=enc, size=d, act="tanh") if context else enc
        inputs = {"x": None, "context": None} if context else {"x": None}
        cell = dec.StateCell(inputs=inputs,
                             states={"h": dec.InitState(init=h0)},
                             out_state="h")

        @cell.state_updater
        def updater(c):
            ins = [c.get_input("x"), c.get_input("context"),
                   c.get_state("h")] if context else c.get_state("h")
            c.set_state("h", layers.fc(input=ins, size=d, act="tanh"))

        init_ids = layers.data(name="init_ids", shape=[1], dtype="int64",
                               lod_level=2)
        init_scores = layers.data(name="init_scores", shape=[1],
                                  dtype="float32", lod_level=2)
        jd = dec.JitBeamSearchDecoder(
            cell, init_ids, init_scores, target_dict_dim=v, word_dim=d,
            input_var_dict={"context": enc} if context else None,
            max_len=6, beam_size=4, end_id=EOS)
        jd.decode()
        out_ids, out_scores = jd()
    nsteps = next(n for n in main.global_block().vars
                  if n.startswith("jbs_nsteps"))
    return main, startup, [out_ids.name, out_scores.name, nsteps]


def _run_jit_case(fluid, context, weights):
    main, startup, fetches = _jit_case(fluid, context)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.executor.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    if weights is None:
        weights = _arrays(fluid, scope, startup)
        if not context:
            # the projection puts all mass on end_id: every beam ends at
            # step 1, the fanned-out stragglers at step 2
            weights[params[-2]] = np.zeros_like(weights[params[-2]])
            bias = np.full(weights[params[-1]].shape, -30.0, np.float32)
            bias[EOS] = 30.0
            weights[params[-1]] = bias
    if fluid is tf:
        load_reference_params(scope, weights, tf.CPUPlace())
    else:
        for name, arr in weights.items():
            scope.set(name, arr)
    feed = decode_feed(fluid, [2, 3, 4], init=0)
    out = [_np(v) for v in exe.run(main, feed=feed, fetch_list=fetches,
                                   scope=scope, return_numpy=False)]
    return out, weights


@pytest.mark.parametrize("context", [False, True],
                         ids=["early_exit", "context_vars"])
def test_jit_cases_match_reference(context):
    want, weights = _run_jit_case(rf, context, None)
    got, _ = _run_jit_case(tf, context, weights)
    (g_ids, g_lod), (g_sc, _), (g_n, _) = got
    (w_ids, w_lod), (w_sc, _), (w_n, _) = want
    np.testing.assert_array_equal(g_ids, w_ids)
    assert g_lod == w_lod
    np.testing.assert_allclose(g_sc, w_sc, rtol=0, atol=ATOL)
    assert int(g_n.reshape(-1)[0]) == int(w_n.reshape(-1)[0])
    if not context:
        assert int(g_n.reshape(-1)[0]) == 3
        src, off = g_lod
        for s in range(3):
            best = g_ids.ravel()[off[src[s]]:off[src[s] + 1]]
            np.testing.assert_array_equal(best, [0, EOS])


BENCH = dict(v=1000, d=64, max_len=16, beam=4, topk=50, seed=5)


def _bench_feed(fluid, batch=8):
    rng = np.random.RandomState(0)
    return decode_feed(fluid, rng.randint(2, BENCH["v"], size=batch),
                       init=0)


def test_bench_widths_both_engines_agree():
    jit = run_decode(tf, "JitBeamSearchDecoder", None, _bench_feed(tf),
                     **BENCH)
    weights = jit[3]
    eager = run_decode(tf, "BeamSearchDecoder", weights, _bench_feed(tf),
                       **BENCH)
    want = run_decode(rf, "BeamSearchDecoder", weights, _bench_feed(rf),
                      **BENCH)
    _same(jit, want)
    _same(eager, want)
    assert jit[0].size == 8 * 4 * 17


def test_jit_engine_goes_with_its_program():
    """The op keeps its engine (static buffers, and on the card the graph
    and its pool); nothing else holds it once the program and the
    executor that ran it are dropped."""
    main, startup, out_ids, out_scores = build_decode(
        tf, "JitBeamSearchDecoder")
    exe, scope = tf.Executor(tf.CPUPlace()), tf.executor.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=decode_feed(tf, [3, 4]),
            fetch_list=[out_ids, out_scores], scope=scope)
    (op,) = [op for op in main.global_block().ops
             if op.type == "jit_beam_search"]
    (engine,) = op._jit_engines.values()
    assert isinstance(engine, beam_search_jit.JitEngine)
    gone = weakref.ref(engine)
    del main, startup, out_ids, out_scores, exe, scope, op, engine
    gc.collect()
    assert gone() is None
