"""The port's sequence (LoD) ops (``paddle_tpu_torch/ops/sequence_ops.py``)
against the JAX package's, on the CPU: each case builds the same
one-op Program in both packages from the same calls, feeds the same
numpy-seeded LoD inputs (ragged lengths with a sequence of length 1, and
empty sequences where the reference allows them), and compares

 - every output (fp32 rtol 1e-5 / atol 1e-6; integer outputs exactly) and
   its LoD, fetched with ``return_numpy=False``;
 - the grads of the differentiable inputs, from ``append_backward`` of
   ``sum(out * c)`` with a numpy-seeded ``c`` per float output (the
   same tolerance).

Inputs whose values the reference reads on the host (``sequence_slice``'s
offsets and lengths, ``sequence_unpad``'s lengths without a LoD,
``sequence_mask``'s ``maxlen=-1``, ``lod_reset`` from a tensor) come from
``assign`` constants, as the reference needs them.  The max-pool cases
include a sequence whose column holds two equal maxima: the grad splits
evenly between them in both packages.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def feed(arr, lens=None, diff=False):
    """A fed input: its array, its recursive lengths (or None) and
    whether its grad is compared."""
    return ("feed", arr, lens, diff)


def const(arr):
    """An input made by ``assign`` (a constant of the Program)."""
    return ("const", arr)


def _pool_x():
    rng = np.random.RandomState(0)
    x = _f32(rng, 9, 3)
    # sequence [1:4) holds two equal maxima in column 0
    x[1, 0] = x[3, 0] = 5.0
    return x


POOL_LENS = [[1, 3, 0, 5]]


def _cases():
    rng = np.random.RandomState(1)
    cases = {}
    for pool in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        outs = ("Out", "MaxIndex") if pool == "MAX" else ("Out",)
        cases[f"pool_{pool.lower()}"] = (
            "sequence_pool", {"X": [feed(_pool_x(), POOL_LENS, True)]},
            {"pooltype": pool}, outs)
    cases["pool_max_2level"] = (
        "sequence_pool",
        {"X": [feed(_f32(rng, 7, 2), [[2, 1], [1, 2, 4]], True)]},
        {"pooltype": "MAX"}, ("Out",))
    cases["softmax"] = (
        "sequence_softmax", {"X": [feed(_f32(rng, 8, 1), [[3, 0, 1, 4]],
                                        True)]}, {}, ("Out",))
    cases["expand"] = (
        "sequence_expand",
        {"X": [feed(_f32(rng, 4, 2), [[1, 3]], True)],
         "Y": [feed(_f32(rng, 5, 1), [[2, 3]])]},
        {"ref_level": -1}, ("Out",))
    cases["expand_rows"] = (
        "sequence_expand",
        {"X": [feed(_f32(rng, 3, 2), None, True)],
         "Y": [feed(_f32(rng, 6, 1), [[1, 3, 2]])]}, {}, ("Out",))
    cases["expand_as"] = (
        "sequence_expand_as",
        {"X": [feed(_f32(rng, 3, 2), None, True)],
         "Y": [feed(_f32(rng, 6, 1), [[1, 3, 2]])]}, {}, ("Out",))
    cases["concat"] = (
        "sequence_concat",
        {"X": [feed(_f32(rng, 4, 2), [[1, 3]], True),
               feed(_f32(rng, 5, 2), [[3, 2]], True)]}, {}, ("Out",))
    cases["reverse"] = (
        "sequence_reverse", {"X": [feed(_f32(rng, 6, 2), [[1, 5]], True)]},
        {}, ("Y",))
    cases["reshape"] = (
        "sequence_reshape", {"X": [feed(_f32(rng, 6, 4), [[1, 2, 3]],
                                        True)]}, {"new_dim": 2}, ("Out",))
    cases["slice"] = (
        "sequence_slice",
        {"X": [feed(_f32(rng, 9, 2), [[4, 1, 4]], True)],
         "Offset": [const(np.array([[1], [0], [2]], np.int64))],
         "Length": [const(np.array([[2], [1], [2]], np.int64))]},
        {}, ("Out",))
    cases["pad"] = (
        "sequence_pad",
        {"X": [feed(_f32(rng, 6, 2), [[2, 1, 3]], True)],
         "PadValue": [const(np.array([-1.5], np.float32))]},
        {"padded_length": -1}, ("Out", "Length"))
    cases["pad_fixed"] = (
        "sequence_pad",
        {"X": [feed(_f32(rng, 4, 3), [[1, 3]], True)],
         "PadValue": [const(np.array([0.25], np.float32))]},
        {"padded_length": 5}, ("Out", "Length"))
    cases["unpad"] = (
        "sequence_unpad",
        {"X": [feed(_f32(rng, 3, 4, 2), None, True)],
         "Length": [const(np.array([2, 4, 1], np.int64))]}, {}, ("Out",))
    cases["mask"] = (
        "sequence_mask", {"X": [const(np.array([1, 0, 3], np.int64))]},
        {"maxlen": -1, "out_dtype": "int64"}, ("Y",))
    cases["mask_maxlen"] = (
        "sequence_mask", {"X": [feed(np.array([2, 4], np.int64))]},
        {"maxlen": 5, "out_dtype": "float32"}, ("Y",))
    cases["enumerate"] = (
        "sequence_enumerate",
        {"X": [feed(np.arange(1, 7, dtype=np.int64).reshape(6, 1),
                    [[3, 1, 2]])]},
        {"win_size": 3, "pad_value": 0}, ("Out",))
    cases["lod_reset_attr"] = (
        "lod_reset", {"X": [feed(_f32(rng, 6, 1), [[3, 3]], True)]},
        {"target_lod": [0, 1, 4, 6]}, ("Out",))
    cases["lod_reset_y_lod"] = (
        "lod_reset",
        {"X": [feed(_f32(rng, 5, 2), [[5]], True)],
         "Y": [feed(_f32(rng, 5, 1), [[2, 3]])]}, {}, ("Out",))
    cases["lod_reset_y_values"] = (
        "lod_reset",
        {"X": [feed(_f32(rng, 5, 2), None, True)],
         "Y": [const(np.array([0, 4, 5], np.int64))]}, {}, ("Out",))
    cases["conv"] = (
        "sequence_conv",
        {"X": [feed(_f32(rng, 8, 3), [[1, 4, 3]], True)],
         "Filter": [feed(_f32(rng, 9, 4), None, True)]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1},
        ("Out",))
    cases["conv_no_filter"] = (
        "sequence_conv", {"X": [feed(_f32(rng, 6, 2), [[2, 4]], True)]},
        {"contextLength": 4, "contextStart": -2, "contextStride": 1},
        ("Out",))
    cases["row_conv"] = (
        "row_conv",
        {"X": [feed(_f32(rng, 7, 3), [[1, 2, 4]], True)],
         "Filter": [feed(_f32(rng, 3, 3), None, True)]}, {}, ("Out",))
    cases["erase"] = (
        "sequence_erase",
        {"X": [feed(np.array([[3], [0], [2], [5], [2], [7], [0]], np.int64),
                    [[4, 2, 1]])]}, {"tokens": [0, 2]}, ("Out",))
    scores = _f32(rng, 9, 1)
    labels = np.array([[2], [0], [1], [3], [0], [0], [1], [2], [2]],
                      np.float32)
    cases["lambda_cost"] = (
        "lambda_cost",
        {"X": [feed(scores, [[4, 2, 3]], True)],
         "Label": [feed(labels, [[4, 2, 3]])]},
        {"NDCG_num": 3, "max_sort_size": -1}, ("Out",))
    cases["lambda_cost_sorted_window"] = (
        "lambda_cost",
        {"X": [feed(scores, [[5, 4]], True)],
         "Label": [feed(labels, [[5, 4]])]},
        {"NDCG_num": 2, "max_sort_size": 3}, ("Out",))
    cases["sub_nested_seq"] = (
        "sub_nested_seq",
        {"X": [feed(_f32(rng, 9, 2), [[2, 3], [1, 2, 2, 1, 3]], True)],
         "SelectedIndices": [feed(np.array([[1], [2], [0]], np.int64),
                                  [[1, 2]])]}, {}, ("Out",))
    return cases


CASES = _cases()


def _build(pkg, case, grad_weights=None):
    """The case's op in a fresh Program; with ``grad_weights`` (output
    slot -> array) also ``sum(out * c)`` over them and its backward.
    Returns (main, feed, output names, grad names)."""
    op_type, inputs, attrs, outs = case
    main, startup = pkg.Program(), pkg.Program()
    feeds, names, grads = {}, {}, []
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        for slot, items in inputs.items():
            names[slot] = []
            for j, item in enumerate(items):
                if item[0] == "const":
                    v = pkg.layers.assign(item[1])
                    names[slot].append(v.name)
                    continue
                _, arr, lens, diff = item
                nm = f"{slot.lower()}_{j}"
                block.create_var(name=nm, shape=arr.shape,
                                 dtype=str(arr.dtype), is_data=True,
                                 stop_gradient=not diff)
                feeds[nm] = pkg.create_lod_tensor(arr, lens) if lens \
                    else arr
                names[slot].append(nm)
                if diff:
                    grads.append(nm + "@GRAD")
        out_names = {}
        for slot in outs:
            out_names[slot] = f"out_{slot}"
            block.create_var(name=f"out_{slot}", shape=(1,), dtype="float32")
        block.append_op(type=op_type, inputs=names,
                        outputs={s: [n] for s, n in out_names.items()},
                        attrs=dict(attrs))
        if grad_weights:
            total = None
            for slot, c in grad_weights.items():
                cv = block.create_var(name=f"c_{slot}", shape=c.shape,
                                      dtype="float32", is_data=True)
                feeds[cv.name] = c
                prod = pkg.layers.elementwise_mul(
                    block.var(out_names[slot]), cv)
                part = pkg.layers.reduce_sum(prod)
                total = part if total is None else \
                    pkg.layers.elementwise_add(total, part)
            pkg.append_backward(total)
    return main, feeds, [out_names[s] for s in outs], grads


def _lod(v):
    return tuple(tuple(level) for level in v.lod()) if hasattr(v, "lod") \
        else ()


def _run(pkg, main, feeds, fetches):
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(main, feed=feeds, fetch_list=fetches, scope=pkg.Scope(),
                   return_numpy=False)


def compare_with_reference(case, tol=None):
    """Run ``case`` (op type, inputs, attrs, output slots) in both
    packages: outputs and their LoDs, then the differentiable inputs'
    grads, within ``tol`` (default ``TOL``)."""
    tol = tol or TOL
    rmain, rfeeds, routs, _ = _build(rf, case)
    ref = _run(rf, rmain, rfeeds, routs)
    pmain, pfeeds, pouts, _ = _build(tf, case)
    port = _run(tf, pmain, pfeeds, pouts)
    for slot, r, p in zip(case[3], ref, port):
        ra, pa = np.asarray(r), np.asarray(p)
        assert pa.shape == ra.shape, (slot, pa.shape, ra.shape)
        if np.issubdtype(ra.dtype, np.floating):
            np.testing.assert_allclose(pa, ra, err_msg=slot, **tol)
        else:
            np.testing.assert_array_equal(pa, ra, err_msg=slot)
        assert _lod(p) == _lod(r), (slot, _lod(p), _lod(r))

    float_outs = [s for s, r in zip(case[3], ref)
                  if np.issubdtype(np.asarray(r).dtype, np.floating)]
    if not any(item[0] == "feed" and item[3]
               for items in case[1].values() for item in items) \
            or not float_outs:
        return
    rng = np.random.RandomState(7)
    weights = {s: rng.standard_normal(np.asarray(r).shape).astype(
        np.float32) for s, r in zip(case[3], ref) if s in float_outs}
    rmain, rfeeds, _, rgrads = _build(rf, case, weights)
    pmain, pfeeds, _, pgrads = _build(tf, case, weights)
    assert pgrads == rgrads
    ref_g = _run(rf, rmain, rfeeds, rgrads)
    port_g = _run(tf, pmain, pfeeds, pgrads)
    for n, r, p in zip(rgrads, ref_g, port_g):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), err_msg=n,
                                   **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_op_matches_reference(name):
    compare_with_reference(CASES[name])


def test_max_pool_tie_splits_the_grad():
    """Two equal maxima in one column share its grad evenly in both
    packages (the reference's segment_max grad)."""
    case = CASES["pool_max"]
    w = {"Out": np.ones((4, 3), np.float32)}
    out = {}
    for pkg in (rf, tf):
        main, feeds, _, grads = _build(pkg, case, w)
        out[pkg] = np.asarray(_run(pkg, main, feeds, grads)[0])
    np.testing.assert_allclose(out[tf], out[rf], **TOL)
    np.testing.assert_allclose(out[tf][[1, 3], 0], [0.5, 0.5])
    assert out[tf][2, 0] == 0.0


def test_index_cache_is_bounded_and_reused():
    """Index maps are built once per (offsets, device) and the cache stays
    within its cap."""
    from paddle_tpu_torch.ops import sequence_ops as so

    calls = []

    def build():
        calls.append(1)
        return np.arange(3)

    a = so.device_index(("probe", (0, 3)), "cpu", build)
    b = so.device_index(("probe", (0, 3)), "cpu", build)
    assert a is b and len(calls) == 1
    for k in range(so._INDEX_CACHE_CAP + 5):
        so.device_index(("probe", k), "cpu", lambda: np.zeros(1))
    assert len(so._INDEX_CACHE) <= so._INDEX_CACHE_CAP
