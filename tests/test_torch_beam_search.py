"""The beam ops (``paddle_tpu_torch/ops/array_ops.py`` ``beam_search``,
``beam_search_decode``, ``beam_search_pack``) against the JAX package, on
the CPU: the four programs of the reference's ``tests/test_beam_search.py``
(a top-k step, an ended beam frozen, a step into a decode, a two-step
backtrack) and ``beam_search_pack`` on dense histories with dead lanes
and early ends, each built by the same calls in both packages (the same
ops, inputs, outputs and attrs): ids and LoDs equal, scores within
1e-6."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework

ATOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _np(v):
    if hasattr(v, "lod") and callable(v.lod):
        return np.asarray(v), tuple(tuple(int(o) for o in lvl)
                                    for lvl in v.lod())
    if isinstance(v, torch.Tensor):
        return v.detach().numpy(), ()
    return np.asarray(v), ()


def build_step_topk(fluid):
    layers = fluid.layers
    pre_ids = layers.data("pre_ids", shape=[4, 1], dtype="int64",
                          append_batch_size=False)
    ids = layers.data("ids", shape=[4, 3], dtype="int64",
                      append_batch_size=False, lod_level=1)
    scores = layers.data("scores", shape=[4, 3], dtype="float32",
                         append_batch_size=False, lod_level=1)
    sel_ids, sel_scores = layers.beam_search(pre_ids, None, ids, scores,
                                             beam_size=2, end_id=0)
    cand_scores = np.array([[0.1, 0.9, 0.2], [0.8, 0.3, 0.4],
                            [0.5, 0.6, 0.1], [0.7, 0.2, 0.3]], np.float32)
    feed = {"pre_ids": np.array([[1], [2], [3], [4]], np.int64),
            "ids": fluid.create_lod_tensor(
                np.arange(12, dtype=np.int64).reshape(4, 3) + 10, [[2, 2]]),
            "scores": fluid.create_lod_tensor(cand_scores, [[2, 2]])}
    return [sel_ids, sel_scores], feed


def build_ended_beam(fluid):
    layers = fluid.layers
    pre_ids = layers.data("pre_ids", shape=[2, 1], dtype="int64",
                          append_batch_size=False)
    ids = layers.data("ids", shape=[2, 2], dtype="int64",
                      append_batch_size=False, lod_level=1)
    scores = layers.data("scores", shape=[2, 2], dtype="float32",
                         append_batch_size=False, lod_level=1)
    sel_ids, sel_scores = layers.beam_search(pre_ids, None, ids, scores,
                                             beam_size=2, end_id=0)
    feed = {"pre_ids": np.array([[0], [5]], np.int64),
            "ids": fluid.create_lod_tensor(
                np.array([[7, 8], [9, 10]], np.int64), [[2]]),
            "scores": fluid.create_lod_tensor(
                np.array([[0.95, 0.4], [0.5, 0.3]], np.float32), [[2]])}
    return [sel_ids, sel_scores], feed


def build_step_into_decode(fluid):
    layers = fluid.layers
    zero = layers.fill_constant(shape=[1], dtype="int64", value=0)
    one = layers.fill_constant(shape=[1], dtype="int64", value=1)
    pre0 = layers.data("pre0", shape=[2, 1], dtype="int64",
                       append_batch_size=False)
    ids1 = layers.data("ids1", shape=[2, 2], dtype="int64",
                       append_batch_size=False, lod_level=1)
    sc1 = layers.data("sc1", shape=[2, 2], dtype="float32",
                      append_batch_size=False, lod_level=1)
    s_ids, s_sc = layers.beam_search(pre0, None, ids1, sc1, beam_size=2,
                                     end_id=0)
    id_arr = layers.array_write(layers.cast(pre0, "int64"), zero)
    layers.array_write(s_ids, one, array=id_arr)
    sc0 = layers.fill_constant(shape=[2, 1], dtype="float32", value=0.0)
    sc_arr = layers.array_write(sc0, zero)
    layers.array_write(s_sc, one, array=sc_arr)
    out_ids, out_sc = layers.beam_search_decode(id_arr, sc_arr, beam_size=2,
                                                end_id=-1)
    feed = {"pre0": np.array([[7], [8]], np.int64),
            "ids1": fluid.create_lod_tensor(
                np.array([[3, 4], [5, 6]], np.int64), [[2]]),
            "sc1": fluid.create_lod_tensor(
                np.array([[0.1, 0.2], [0.9, 0.8]], np.float32), [[2]])}
    return [out_ids, out_sc], feed


def build_decode_backtrack(fluid):
    layers = fluid.layers
    zero = layers.fill_constant(shape=[1], dtype="int64", value=0)
    one = layers.fill_constant(shape=[1], dtype="int64", value=1)
    names = ("s0_ids", "s1_ids", "s0_sc", "s1_sc")
    v = {n: layers.data(n, shape=[2, 1], dtype="int64" if "ids" in n
                        else "float32", append_batch_size=False, lod_level=2)
         for n in names}
    ids_arr = layers.array_write(v["s0_ids"], zero)
    layers.array_write(v["s1_ids"], one, array=ids_arr)
    sc_arr = layers.array_write(v["s0_sc"], zero)
    layers.array_write(v["s1_sc"], one, array=sc_arr)
    out_ids, out_sc = layers.beam_search_decode(ids_arr, sc_arr, beam_size=2,
                                                end_id=-1)
    lod = [[2], [1, 1]]
    feed = {"s0_ids": fluid.create_lod_tensor(
                np.array([[3], [4]], np.int64), lod),
            "s1_ids": fluid.create_lod_tensor(
                np.array([[5], [6]], np.int64), lod),
            "s0_sc": fluid.create_lod_tensor(
                np.array([[0.5], [0.4]], np.float32), lod),
            "s1_sc": fluid.create_lod_tensor(
                np.array([[0.9], [0.8]], np.float32), lod)}
    return [out_ids, out_sc], feed


def pack_histories(steps=5, batch=3, beam=4, end_id=1, seed=0):
    """Dense jit-engine histories: random tokens and parents, scores that
    fall along each chain, dead lanes (NEG_INF) in the first steps of
    every source's later beams, some chains through end_id."""
    rng = np.random.RandomState(seed)
    h_ids = rng.randint(2, 9, (steps + 2, batch, beam)).astype(np.int64)
    h_ids[2, 0, 1] = end_id
    h_ids[3, 1, 0] = end_id
    h_par = rng.randint(0, beam, (steps + 2, batch, beam)).astype(np.int32)
    h_par[1] = 0
    h_sc = -np.cumsum(rng.rand(steps + 2, batch, beam), 0).astype(np.float32)
    h_sc[0, :, 1:] = -1e30
    h_sc[1:, 2, 3] = -1e30   # a lane of source 2 that never fanned out
    return h_ids, h_par, h_sc, np.array([steps], np.int32)


def build_pack(fluid):
    layers = fluid.layers
    block = fluid.default_main_program().current_block()
    ins = {slot: layers.data(slot, shape=list(shape), dtype=dt,
                             append_batch_size=False)
           for slot, shape, dt in (("HistIds", (7, 3, 4), "int64"),
                                   ("HistParents", (7, 3, 4), "int32"),
                                   ("HistScores", (7, 3, 4), "float32"),
                                   ("NumSteps", (1,), "int32"))}
    ids = block.create_var(name="pack_ids", dtype="int64", shape=(-1, 1),
                           lod_level=2)
    sc = block.create_var(name="pack_sc", dtype="float32", shape=(-1, 1),
                          lod_level=2)
    block.append_op(type="beam_search_pack",
                    inputs={k: [v.name] for k, v in ins.items()},
                    outputs={"SentenceIds": [ids.name],
                             "SentenceScores": [sc.name]},
                    attrs={"end_id": 1})
    return [ids, sc], dict(zip(("HistIds", "HistParents", "HistScores",
                                "NumSteps"), pack_histories()))


CASES = {"step_topk": build_step_topk, "ended_beam": build_ended_beam,
         "step_into_decode": build_step_into_decode,
         "decode_backtrack": build_decode_backtrack, "pack": build_pack}


def _run(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetches, feed = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    out = exe.run(main, feed=feed, fetch_list=[f.name for f in fetches],
                  return_numpy=False)
    sig = [(op.type, dict(op.inputs), dict(op.outputs), dict(
        (k, v) for k, v in op.attrs.items() if not k.startswith("op_")))
        for op in main.global_block().ops]
    return sig, [_np(v) for v in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_op_matches_reference(case):
    rsig, (r_ids, r_sc) = _run(rf, CASES[case])
    psig, (p_ids, p_sc) = _run(tf, CASES[case])
    assert psig == rsig
    np.testing.assert_array_equal(p_ids[0], r_ids[0])
    assert p_ids[1] == r_ids[1] and p_sc[1] == r_sc[1]
    np.testing.assert_allclose(p_sc[0], r_sc[0], rtol=0, atol=ATOL)


def test_beam_search_step_values():
    """The reference test's own expectations, in the port: the top two of
    each source grouped by parent row, and the parent offsets."""
    _, ((ids, lod), (scores, _)) = _run(tf, build_step_topk)
    np.testing.assert_array_equal(ids.ravel(), [11, 13, 17, 19])
    np.testing.assert_allclose(scores.ravel(), [0.9, 0.8, 0.6, 0.7],
                               rtol=1e-6)
    assert lod[1] == (0, 1, 2, 3, 4)
    _, ((ids, _), _) = _run(tf, build_step_into_decode)
    np.testing.assert_array_equal(ids.reshape(-1, 2), [[8, 5], [8, 6]])


def test_pack_drops_dead_lanes_and_cuts_at_end():
    _, ((ids, lod), (scores, _)) = _run(tf, build_pack)
    src, off = lod
    assert src == (0, 4, 8, 11)  # source 2's never-fanned lane is dropped
    flat = ids.ravel()
    for j in range(len(off) - 1):
        chain = flat[off[j]:off[j + 1]]
        assert 1 not in chain[:-1]
    for s in range(3):
        finals = [scores.ravel()[off[j + 1] - 1]
                  for j in range(src[s], src[s + 1])]
        assert finals == sorted(finals, reverse=True)
