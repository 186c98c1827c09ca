"""The port's structured-loss ops (``paddle_tpu_torch/ops/struct_loss_ops.py``)
against the JAX package's, on the CPU.  Each case builds the same one-op
Program in both packages, feeds the same numpy-seeded inputs on ragged
LoD batches (lengths that include 1, and an empty label sequence for the
CTC), and compares, through ``test_torch_sequence_ops.py``'s
``compare_with_reference``,

 - every output (fp32 rtol 1e-5 / atol 1e-6; integer outputs exactly,
   and int64 in both) and its LoD;
 - the grads of the differentiable inputs, from ``append_backward`` of
   ``sum(out * c)`` with a numpy-seeded ``c`` per float output (the same
   tolerance).

Cases: the linear-chain CRF (ragged, and all of length 1, where the scan
over time is empty), Viterbi with and without ``Label``, the CTC loss
(blank first or last, ``norm_by_times``, repeated labels with exactly
``T = L + repeats`` frames, a length-1 sequence, an empty label, and
``WarpCTCGrad``), NCE with ``custom_neg_classes``, the hierarchical
sigmoid over 6 classes (not a power of two), ``edit_distance`` (plain,
normalized and with ``ignored_tokens``), ``chunk_eval`` under IOB, IOE,
IOBES and plain (with ``excluded_chunk_types``), and ``ctc_align`` merged,
unmerged and empty.  Also: NCE's seeded draw is one fixed draw (the same
in two sessions, in range), the CTC refuses a sequence with fewer frames
than labels as the reference does, and ``Executor.run_steps`` refuses a
program holding one of the host ops ``chunk_eval`` / ``ctc_align`` /
``edit_distance``.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import (TOL, _build, _run,
                                     compare_with_reference, feed)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ids(rng, n, hi):
    return rng.randint(0, hi, size=(n, 1)).astype(np.int64)


def _cases():
    rng = np.random.RandomState(3)
    cases = {}
    k = 4
    for name, lens in (("crf", [3, 1, 5, 2]), ("crf_len1", [1, 1, 1])):
        n = sum(lens)
        cases[name] = (
            "linear_chain_crf",
            {"Emission": [feed(_f32(rng, n, k), [lens], True)],
             "Transition": [feed(_f32(rng, k + 2, k) * 0.5, None, True)],
             "Label": [feed(_ids(rng, n, k), [lens])]},
            {}, ("LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"))
    lens = [4, 1, 6, 3]
    em, tr = _f32(rng, sum(lens), 5), _f32(rng, 7, 5)
    lab = _ids(rng, sum(lens), 5)
    cases["viterbi"] = (
        "crf_decoding", {"Emission": [feed(em, [lens])],
                         "Transition": [feed(tr)]}, {}, ("ViterbiPath",))
    cases["viterbi_label"] = (
        "crf_decoding", {"Emission": [feed(em, [lens])],
                         "Transition": [feed(tr)],
                         "Label": [feed(lab, [lens])]}, {}, ("ViterbiPath",))
    cases["viterbi_len1"] = (
        "crf_decoding", {"Emission": [feed(em[:2], [[1, 1]])],
                         "Transition": [feed(tr)]}, {}, ("ViterbiPath",))

    t_lens, n_cls = [6, 4, 1, 8, 3], 6
    labels = [[1, 2], [3, 3, 5], [4], [5, 1, 1, 2], []]  # [3, 3, 5]: T = 4
    lab = np.array([v for s in labels for v in s], np.int64).reshape(-1, 1)
    l_lens = [len(s) for s in labels]
    logits = _f32(rng, sum(t_lens), n_cls)
    for name, blank, shift, norm in (("ctc", 0, 0, False),
                                     ("ctc_blank_last", n_cls - 1, -1, False),
                                     ("ctc_norm_by_times", 0, 0, True)):
        cases[name] = (
            "warpctc",
            {"Logits": [feed(logits, [t_lens], True)],
             "Label": [feed(lab + shift, [l_lens])]},
            {"blank": blank, "norm_by_times": norm},
            ("Loss", "WarpCTCGrad"))

    b, d, c = 5, 4, 9
    cases["nce_custom_neg"] = (
        "nce",
        {"Input": [feed(_f32(rng, b, d), None, True)],
         "Label": [feed(_ids(rng, b, c))],
         "Weight": [feed(_f32(rng, c, d), None, True)],
         "Bias": [feed(_f32(rng, c, 1), None, True)]},
        {"num_total_classes": c, "num_neg_samples": 3,
         "custom_neg_classes": [1, 4, 7]},
        ("Cost", "SampleLogits", "SampleLabels"))
    cases["hsigmoid_6_classes"] = (
        "hierarchical_sigmoid",
        {"X": [feed(_f32(rng, 7, 3), None, True)],
         "W": [feed(_f32(rng, 5, 3), None, True)],
         "Label": [feed(np.arange(7).reshape(-1, 1) % 6)],
         "Bias": [feed(_f32(rng, 1, 5), None, True)]},
        {"num_classes": 6}, ("Out", "PreOut"))

    hyps = np.array([[1], [2], [3], [4], [4], [1], [2]], np.int64)
    refs = np.array([[1], [3], [2], [9], [4], [1], [2], [5]], np.int64)
    for name, norm in (("edit_distance", False),
                       ("edit_distance_normalized", True)):
        cases[name] = (
            "edit_distance",
            {"Hyps": [feed(hyps, [[3, 0, 4]])],
             "Refs": [feed(refs, [[2, 3, 3]])]},
            {"normalized": norm}, ("Out", "SequenceNum"))

    chunk_outs = ("Precision", "Recall", "F1-Score", "NumInferChunks",
                  "NumLabelChunks", "NumCorrectChunks")
    for scheme, n_tag in (("IOB", 2), ("IOE", 2), ("IOBES", 4),
                          ("plain", 1)):
        lens = [7, 1, 9, 5]
        top = 3 * n_tag + 1     # three chunk types and "other"
        inf = _ids(rng, sum(lens), top)
        lab = inf.copy()
        flip = rng.rand(sum(lens)) < 0.3
        lab[flip] = _ids(rng, int(flip.sum()), top)
        cases[f"chunk_eval_{scheme}"] = (
            "chunk_eval",
            {"Inference": [feed(inf, [lens])], "Label": [feed(lab, [lens])]},
            {"chunk_scheme": scheme, "num_chunk_types": 3,
             "excluded_chunk_types": [1] if scheme == "IOB" else []},
            chunk_outs)

    seq = np.array([[0], [2], [2], [0], [3], [3], [1], [1], [0], [0], [4]],
                   np.int64)
    for name, merge in (("ctc_align", True), ("ctc_align_unmerged", False)):
        cases[name] = (
            "ctc_align", {"Input": [feed(seq, [[5, 1, 4, 1]])]},
            {"blank": 0, "merge_repeated": merge}, ("Output",))
    cases["ctc_align_empty"] = (
        "ctc_align", {"Input": [feed(np.zeros((3, 1), np.int64), [[2, 1]])]},
        {"blank": 0, "merge_repeated": True}, ("Output",))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_struct_loss_op_matches_reference(name):
    compare_with_reference(CASES[name])


INT_CASES = sorted(n for n, c in CASES.items() if c[0] in (
    "crf_decoding", "nce", "edit_distance", "chunk_eval", "ctc_align"))


@pytest.mark.parametrize("name", INT_CASES)
def test_integer_outputs_keep_reference_dtype(name):
    """The ids, paths and counts are int64 in both packages."""
    case = CASES[name]
    got = {pkg: _run(pkg, *_build(pkg, case)[:3]) for pkg in (rf, tf)}
    for slot, r, p in zip(case[3], got[rf], got[tf]):
        r, p = np.asarray(r), np.asarray(p)
        if not np.issubdtype(r.dtype, np.floating):
            assert p.dtype == r.dtype == np.int64, (slot, p.dtype, r.dtype)


def _layer_program(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        outs = build(pkg)
    return main, startup, outs


def test_edit_distance_ignored_tokens_matches_reference():
    """``layers.edit_distance(ignored_tokens=...)`` erases the tokens from
    both sides through ``sequence_erase`` first, in both packages."""
    hyps = np.array([[1], [0], [2], [3], [0], [4], [4]], np.int64)
    refs = np.array([[1], [2], [0], [9], [4], [0]], np.int64)

    def build(pkg):
        h = pkg.layers.data(name="h", shape=[1], dtype="int64", lod_level=1)
        r = pkg.layers.data(name="r", shape=[1], dtype="int64", lod_level=1)
        return pkg.layers.edit_distance(h, r, normalized=True,
                                        ignored_tokens=[0])

    got = {}
    for pkg in (rf, tf):
        main, startup, outs = _layer_program(pkg, build)
        exe = pkg.Executor(pkg.CPUPlace())
        got[pkg] = exe.run(main, feed={
            "h": pkg.create_lod_tensor(hyps, [[4, 3]], pkg.CPUPlace()),
            "r": pkg.create_lod_tensor(refs, [[3, 3]], pkg.CPUPlace())},
            fetch_list=list(outs), scope=pkg.Scope())
    types = [op.type for op in _layer_program(tf, build)[0]
             .global_block().ops]
    assert types == ["sequence_erase", "sequence_erase", "edit_distance"]
    for r, p in zip(got[rf], got[tf]):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), **TOL)


def _nce_program(pkg, seed):
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        cost = pkg.layers.nce(x, y, num_total_classes=11,
                              num_neg_samples=5, seed=seed)
        return cost
    return _layer_program(pkg, build)


def test_nce_seeded_draw_is_fixed_and_in_range():
    """A nonzero ``seed`` gives one fixed draw: the same negatives in two
    fresh port sessions and across steps, every id below the class
    count (values differ from the reference's threefry draw)."""
    rng = np.random.RandomState(0)
    feed_ = {"x": _f32(rng, 6, 4), "y": _ids(rng, 6, 11)}
    draws = []
    for _ in range(2):
        port_framework.fresh_session()
        main, startup, _ = _nce_program(tf, seed=17)
        (op,) = [o for o in main.global_block().ops if o.type == "nce"]
        name = op.output("SampleLabels")[0]
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        for _ in range(2):
            (lab,) = exe.run(main, feed=feed_, fetch_list=[name],
                             scope=scope)
            draws.append(np.asarray(lab))
    for d in draws[1:]:
        np.testing.assert_array_equal(d, draws[0])
    neg = draws[0][:, 1:]
    assert neg.shape == (6, 5) and neg.min() >= 0 and neg.max() < 11
    np.testing.assert_array_equal(draws[0][:, :1], feed_["y"])


def test_nce_unseeded_draws_from_the_executor_generator():
    """With ``seed=0`` each step draws fresh negatives from the scope's
    generator: two steps differ, and the same program seed repeats."""
    rng = np.random.RandomState(0)
    feed_ = {"x": _f32(rng, 6, 4), "y": _ids(rng, 6, 11)}
    runs = []
    for _ in range(2):
        port_framework.fresh_session()
        main, startup, _ = _nce_program(tf, seed=0)
        main.random_seed = 3
        (op,) = [o for o in main.global_block().ops if o.type == "nce"]
        name = op.output("SampleLabels")[0]
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        runs.append([np.asarray(exe.run(main, feed=feed_, fetch_list=[name],
                                        scope=scope)[0]) for _ in range(2)])
    assert not np.array_equal(runs[0][0], runs[0][1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_warpctc_refuses_too_few_frames():
    case = ("warpctc",
            {"Logits": [feed(np.zeros((5, 4), np.float32), [[2, 3]])],
             "Label": [feed(np.ones((4, 1), np.int64), [[3, 1]])]},
            {"blank": 0}, ("Loss",))
    for pkg in (rf, tf):
        main, feeds, outs, _ = _build(pkg, case)
        with pytest.raises(ValueError, match="no CTC alignment"):
            _run(pkg, main, feeds, outs)


@pytest.mark.parametrize("op_type", ["chunk_eval", "ctc_align",
                                     "edit_distance"])
def test_host_ops_refuse_run_steps(op_type):
    """A program holding a host metric op is data-dependent
    (``registry.EAGER_OPS``): ``run_steps`` refuses it, as the
    reference's does."""
    from paddle_tpu_torch.ops.registry import EAGER_OPS

    assert op_type in EAGER_OPS
    slots = {"chunk_eval": (("Inference", "Label"), ("Precision",),
                            {"num_chunk_types": 1}),
             "ctc_align": (("Input",), ("Output",), {}),
             "edit_distance": (("Hyps", "Refs"), ("Out",), {})}[op_type]
    ins, outs, attrs = slots
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        block = main.global_block()
        names = {}
        for s in ins:
            block.create_var(name=s.lower(), shape=(3, 1), dtype="int64",
                             is_data=True)
            names[s] = [s.lower()]
        block.create_var(name="out", shape=(1,), dtype="float32")
        block.append_op(type=op_type, inputs=names,
                        outputs={outs[0]: ["out"]}, attrs=attrs)
    exe = tf.Executor(tf.CPUPlace())
    with pytest.raises(RuntimeError, match="data-dependent"):
        exe.run_steps(main, feed={s.lower(): np.zeros((3, 1), np.int64)
                                  for s in ins},
                      fetch_list=["out"], n_steps=2, scope=tf.Scope())


def test_host_ops_keep_outputs_on_the_input_device():
    """The host ops return tensors on their input's device (here the CPU)
    and count a host read only for a tensor off the CPU."""
    import torch

    from paddle_tpu_torch.ops import struct_loss_ops as sl
    from paddle_tpu_torch.ops.registry import ExecContext

    sl.reset_stats()
    x = torch.tensor([[1], [1], [0], [2]])
    ctx = ExecContext("ctc_align", {"Input": [x], "Input@LOD": [((0, 4),)]},
                      {"Output": ["o"]}, {"blank": 0}, x.device)
    out = sl.ctc_align(ctx)
    assert isinstance(out["Output"], torch.Tensor)
    assert out["Output"].tolist() == [[1], [2]]
    assert out["Output@LOD"] == [((0, 2),)]
    assert sl.stats["host_reads"] == 0


def test_warpctc_with_every_label_empty_is_the_all_blank_path():
    """A batch whose label sequences are all empty: the loss is minus the
    log-probability of blank at every frame (the reference's scan fails
    on this batch, ROADMAP queue 3)."""
    logits = np.random.RandomState(0).standard_normal((5, 4)).astype(
        np.float32)
    case = ("warpctc",
            {"Logits": [feed(logits, [[2, 3]])],
             "Label": [feed(np.zeros((0, 1), np.int64), [[0, 0]])]},
            {"blank": 0}, ("Loss",))
    main, feeds, outs, _ = _build(tf, case)
    (loss,) = _run(tf, main, feeds, outs)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    np.testing.assert_allclose(np.asarray(loss).ravel(),
                               [-logp[:2, 0].sum(), -logp[2:, 0].sum()],
                               **TOL)
