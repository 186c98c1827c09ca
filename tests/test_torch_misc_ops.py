"""The port's misc ops (``paddle_tpu_torch/ops/misc_ops.py``) against the
JAX package's, on the CPU:

 - the dense stragglers and the ``2`` shape ops through the one-op
   harness of ``test_torch_sequence_ops.py``: outputs at fp32 rtol 1e-5 /
   atol 1e-6 (integers and ``XShape`` shapes equal), and the input grads
   from ``append_backward`` of ``sum(out * c)`` at the same tolerance;
   ``cos_sim`` with a ``[1, D]`` ``Y``, ``modified_huber_loss`` over all
   three of its pieces, ``label_smooth`` with and without a prior;
 - ``random_crop``: in both packages every crop a true window of its
   instance; in the port, over 4,000 instances, every start equally
   likely (chi-square at 0.1 %: 16.27 for 4 starts, 43.82 for 20);
 - the SelectedRows utilities run op by op (``run_op``) on the same
   rows and values: equal rows, values and heights, NaN rows of
   ``merge_ids`` where both put them;
 - ``save`` / ``load`` / ``save_combine`` / ``load_combine`` /
   ``delete_var``: a file either package writes, the other loads to the
   same array; the Executor runs a ``save`` no fetch needs, and
   ``run_steps`` refuses a program that holds one;
 - ``get_places`` and the builders ``cos_sim``, ``mean_iou``,
   ``random_crop``, ``load`` and ``get_places``: the reference's Program.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import executor as ref_exec
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid.selected_rows import SelectedRows as RefRows
from paddle_tpu_torch.fluid import executor as port_exec
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid.selected_rows import SelectedRows as PortRows
from test_torch_activation_ops_rest import _builder_program, _data
from test_torch_sequence_ops import _build, _run, compare_with_reference, \
    const, feed

CHI2_999 = {3: 16.27, 19: 43.82}  # chi-square quantile 0.999 by dof


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _dense_cases():
    huber_x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(12, 1)
    huber_y = (np.arange(12) % 2).astype(np.float32).reshape(12, 1)
    return {
        "minus": ("minus", {"X": [feed(_f32(1, 3, 4), None, True)],
                            "Y": [feed(_f32(2, 3, 4), None, True)]},
                  {}, ("Out",)),
        "cos_sim": ("cos_sim", {"X": [feed(_f32(3, 5, 8), None, True)],
                                "Y": [feed(_f32(4, 5, 8), None, True)]},
                    {}, ("Out", "XNorm", "YNorm")),
        "cos_sim_row": ("cos_sim", {"X": [feed(_f32(5, 5, 8), None, True)],
                                    "Y": [feed(_f32(6, 1, 8), None, True)]},
                        {}, ("Out", "XNorm", "YNorm")),
        "l1_norm": ("l1_norm", {"X": [feed(_f32(7, 4, 6), None, True)]},
                    {}, ("Out",)),
        "norm": ("norm", {"X": [feed(_f32(8, 3, 5, 4), None, True)]},
                 {"axis": 1, "epsilon": 1e-10}, ("Out", "Norm")),
        "bilinear_tensor_product": (
            "bilinear_tensor_product",
            {"X": [feed(_f32(9, 4, 3), None, True)],
             "Y": [feed(_f32(10, 4, 5), None, True)],
             "Weight": [feed(_f32(11, 6, 3, 5), None, True)],
             "Bias": [feed(_f32(12, 1, 6), None, True)]}, {}, ("Out",)),
        "bilinear_tensor_product_no_bias": (
            "bilinear_tensor_product",
            {"X": [feed(_f32(13, 4, 3), None, True)],
             "Y": [feed(_f32(14, 4, 5), None, True)],
             "Weight": [feed(_f32(15, 2, 3, 5), None, True)]}, {}, ("Out",)),
        "conv_shift": ("conv_shift", {"X": [feed(_f32(16, 3, 7), None, True)],
                                      "Y": [feed(_f32(17, 3, 3), None, True)]},
                       {}, ("Out",)),
        "modified_huber_loss": (
            "modified_huber_loss", {"X": [feed(huber_x, None, True)],
                                    "Y": [feed(huber_y)]},
            {}, ("Out", "IntermediateVal")),
        "label_smooth": ("label_smooth",
                         {"X": [feed(np.abs(_f32(18, 4, 5)), None, True)]},
                         {"epsilon": 0.1}, ("Out",)),
        "label_smooth_prior": (
            "label_smooth",
            {"X": [feed(np.abs(_f32(19, 4, 5)), None, True)],
             "PriorDist": [const(np.full((1, 5), 0.2, np.float32))]},
            {"epsilon": 0.2}, ("Out",)),
        "fill": ("fill", {}, {"value": [1.5, -2.0, 3.25, 0.0, 7.0, 8.5],
                              "shape": [2, 3], "dtype": 5}, ("Out",)),
        "fill_int64": ("fill", {}, {"value": [4, -1, 9], "shape": [3, 1],
                                    "dtype": 3}, ("Out",)),
        "flatten2": ("flatten2", {"X": [feed(_f32(20, 2, 3, 4), None, True)]},
                     {"axis": 2}, ("Out", "XShape")),
        "squeeze2": ("squeeze2", {"X": [feed(_f32(21, 3, 1, 4, 1), None,
                                             True)]},
                     {"axes": [1]}, ("Out", "XShape")),
        "squeeze2_all": ("squeeze2", {"X": [feed(_f32(22, 3, 1, 4, 1), None,
                                                 True)]},
                         {"axes": []}, ("Out", "XShape")),
        "unsqueeze2": ("unsqueeze2", {"X": [feed(_f32(23, 3, 4), None,
                                                 True)]},
                       {"axes": [0, 3]}, ("Out", "XShape")),
    }


DENSE = _dense_cases()


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_op_matches_reference(name):
    compare_with_reference(DENSE[name])


# -- random_crop -------------------------------------------------------------

def _crop_outputs(pkg, x, shape):
    case = ("random_crop", {"X": [feed(x)]}, {"shape": list(shape)},
            ("Out",))
    main, feeds, outs, _ = _build(pkg, case)
    main.random_seed = 5
    return np.asarray(_run(pkg, main, feeds, outs)[0])


def _starts(x, out, shape):
    """Each instance's window start, found by matching its crop; raises
    if a crop is no window of its instance."""
    lead = x.ndim - len(shape)
    rows = x.reshape((-1,) + x.shape[lead:]) if lead else x[None]
    crops = out.reshape((-1,) + tuple(shape)) if lead else out[None]
    found = []
    for inst, crop in zip(rows, crops):
        hits = [s for s in np.ndindex(*[d - k + 1 for d, k in zip(
            inst.shape, shape)])
            if np.array_equal(inst[tuple(slice(a, a + k) for a, k in zip(
                s, shape))], crop)]
        assert hits, "a crop that is no window of its instance"
        found.append(hits[0])
    return found


@pytest.mark.parametrize("x_shape,shape", [((6, 9), (4,)),
                                           ((5, 6, 7), (3, 4)),
                                           ((5, 7), (2, 3))],
                         ids=["1d", "2d", "unbatched"])
def test_random_crop_takes_windows_in_both(x_shape, shape):
    x = np.random.RandomState(0).permutation(
        np.arange(np.prod(x_shape), dtype=np.float32)).reshape(x_shape)
    for pkg in (rf, tf):
        out = _crop_outputs(pkg, x, shape)
        lead = len(x_shape) - len(shape)
        assert out.shape == x_shape[:lead] + tuple(shape)
        _starts(x, out, shape)


@pytest.mark.parametrize("x_shape,shape", [((4000, 6), (3,)),
                                           ((4000, 5, 7), (2, 3))],
                         ids=["4_starts", "20_starts"])
def test_random_crop_starts_are_uniform(x_shape, shape):
    n = x_shape[0]
    x = np.arange(np.prod(x_shape), dtype=np.float32).reshape(x_shape)
    out = _crop_outputs(tf, x, shape)
    cells = [d - k + 1 for d, k in zip(x_shape[1:], shape)]
    # a ramp: a crop's first value gives its start
    first = out.reshape(n, -1)[:, 0] - x.reshape(n, -1)[:, 0]
    starts = np.stack(np.unravel_index(first.astype(np.int64),
                                       x_shape[1:]), 1)
    assert (starts < np.array(cells)).all()
    counts = np.bincount(np.ravel_multi_index(starts.T, cells),
                         minlength=int(np.prod(cells)))
    expect = n / counts.size
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 <= CHI2_999[counts.size - 1], (chi2, counts)
    np.testing.assert_array_equal(out[:50], np.stack(
        [x[i][tuple(slice(a, a + k) for a, k in zip(_starts(
            x[i:i + 1], out[i:i + 1], shape)[0], shape))]
         for i in range(50)]))


# -- SelectedRows utilities ---------------------------------------------------

def _rows(pkg, rows, values, height):
    if pkg is rf:
        return RefRows(jnp.asarray(rows), jnp.asarray(values), height)
    return PortRows(torch.from_numpy(rows), torch.from_numpy(values), height)


def _run_one(pkg, op_type, inputs, attrs, outputs):
    """``op_type`` as one op of a fresh Program, run by the package's
    ``run_op`` on ``inputs`` (slot -> list of values); returns slot ->
    list of outputs."""
    main = pkg.Program()
    block = main.global_block()
    env, in_names = {}, {}
    for slot, vals in inputs.items():
        in_names[slot] = []
        for j, v in enumerate(vals):
            name = f"{slot}_{j}"
            block.create_var(name=name, shape=(1,), dtype="float32")
            env[name] = v
            in_names[slot].append(name)
    out_names = {slot: [f"out_{slot}_{j}" for j in range(n)]
                 for slot, n in outputs.items()}
    for names in out_names.values():
        for name in names:
            block.create_var(name=name, shape=(1,), dtype="float32")
    op = block.append_op(type=op_type, inputs=in_names, outputs=out_names,
                         attrs=dict(attrs))
    if pkg is rf:
        ref_exec.run_op(op, env, [jax.random.PRNGKey(0)])
    else:
        port_exec.run_op(op, env, torch.device("cpu"))
    return {slot: [env[n] for n in names]
            for slot, names in out_names.items()}


def _np(v):
    if isinstance(v, (RefRows, PortRows)):
        return (_np(v.rows), _np(v.values), v.height)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same(a, b):
    if isinstance(a, tuple):
        assert a[2] == b[2]
        for x, y in zip(a[:2], b[:2]):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    np.testing.assert_array_equal(a, b)  # NaN where both hold NaN


SR_ROWS = np.array([3, 0, 7, 3, 9], np.int64)
SR_VALS = _f32(30, 5, 2)
IDS = np.array([[4], [1], [6], [3], [8], [0], [5]], np.int64)


def _sr_cases():
    shard_rows = [np.array([[4], [6], [8], [0]], np.int64),
                  np.array([[1], [3], [5]], np.int64)]
    shard_vals = [_f32(31, 4, 3), _f32(32, 3, 3)]
    return {
        "extract_rows": ("extract_rows", lambda p: {
            "X": [_rows(p, SR_ROWS, SR_VALS, 10)]}, {}, {"Out": 1}),
        "split_ids_2": ("split_ids", lambda p: {"Ids": [_arr(p, IDS)]},
                        {}, {"Out": 2}),
        "split_ids_3": ("split_ids", lambda p: {"Ids": [_arr(p, IDS)]},
                        {}, {"Out": 3}),
        "merge_ids": ("merge_ids", lambda p: {
            "Ids": [_arr(p, np.array([[3], [8], [2], [0]], np.int64))],
            "Rows": [_arr(p, r) for r in shard_rows],
            "X": [_arr(p, v) for v in shard_vals]}, {}, {"Out": 1}),
        "split_selected_rows": ("split_selected_rows", lambda p: {
            "X": [_rows(p, SR_ROWS, SR_VALS, 10)]},
            {"height_sections": [4, 6]}, {"Out": 2}),
    }


def _arr(pkg, a):
    return jnp.asarray(a) if pkg is rf else torch.from_numpy(a)


SR_CASES = _sr_cases()


@pytest.mark.parametrize("name", sorted(SR_CASES))
def test_selected_rows_op_matches_reference(name):
    op_type, inputs, attrs, outputs = SR_CASES[name]
    ref = _run_one(rf, op_type, inputs(rf), attrs, outputs)
    port = _run_one(tf, op_type, inputs(tf), attrs, outputs)
    for slot in outputs:
        assert len(port[slot]) == len(ref[slot])
        for r, p in zip(ref[slot], port[slot]):
            _same(_np(p), _np(r))
    if name == "merge_ids":  # id 2 is in no shard
        assert np.isnan(_np(port["Out"][0])[2]).all()


# -- in-graph checkpoint ops ---------------------------------------------------

def _save_program(pkg, path, combine):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        a = pkg.layers.data("a", shape=[3], dtype="float32")
        b = pkg.layers.data("b", shape=[2], dtype="int64")
        block = main.global_block()
        if combine:
            block.append_op(type="save_combine", inputs={"X": [a, b]},
                            outputs={}, attrs={"file_path": path})
        else:
            block.append_op(type="save", inputs={"X": [a]}, outputs={},
                            attrs={"file_path": path})
        block.append_op(type="delete_var", inputs={"X": [a]}, outputs={})
    return main


def _load_program(pkg, path, combine):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        a = block.create_var(name="la", shape=(4, 3), dtype="float32")
        b = block.create_var(name="lb", shape=(4, 2), dtype="int64")
        if combine:
            block.append_op(type="load_combine", inputs={},
                            outputs={"Out": [a, b]},
                            attrs={"file_path": path})
        else:
            pkg.layers.load(a, path)
    return main, ([a, b] if combine else [a])


@pytest.mark.parametrize("combine", [False, True], ids=["save", "combine"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_cross_packages(tmp_path, writer, combine):
    w, r = (tf, rf) if writer == "port" else (rf, tf)
    path = str(tmp_path / ("ckpt.npz" if combine else "ckpt"))
    feed = {"a": _f32(40, 4, 3),
            "b": np.arange(8, dtype=np.int64).reshape(4, 2)}
    exe = w.Executor(w.CPUPlace())
    # no fetch needs the save: the Executor runs it all the same
    exe.run(_save_program(w, path, combine), feed=feed, fetch_list=[],
            scope=w.Scope())
    assert os.path.exists(path if combine else path + ".npy")
    main, outs = _load_program(r, path, combine)
    got = r.Executor(r.CPUPlace()).run(main, fetch_list=outs,
                                       scope=r.Scope())
    for want, g in zip((feed["a"], feed["b"]), got):
        g = np.asarray(g)
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


def test_run_steps_refuses_a_program_that_saves(tmp_path):
    main = _save_program(tf, str(tmp_path / "w"), False)
    feed = {"a": _f32(41, 4, 3),
            "b": np.zeros((4, 2), np.int64)}
    with pytest.raises(RuntimeError, match="eager"):
        tf.Executor(tf.CPUPlace()).run_steps(main, feed, [], 2,
                                             scope=tf.Scope())
    assert not os.path.exists(str(tmp_path / "w.npy"))


def test_get_places():
    outs = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            three = pkg.layers.get_places(device_count=3)
            default = pkg.layers.get_places()
        outs.append(pkg.Executor(pkg.CPUPlace()).run(
            main, fetch_list=[three, default], scope=pkg.Scope()))
    (r3, _), (p3, pdef) = outs
    np.testing.assert_array_equal(np.asarray(p3), np.asarray(r3))
    assert np.asarray(p3).dtype == np.int64
    np.testing.assert_array_equal(np.asarray(pdef), [0])  # one CPU


def _builder(name):
    def build(pkg):
        if name == "cos_sim":
            pkg.layers.cos_sim(_data(pkg, "x", (8,)), _data(pkg, "y", (8,)))
        elif name == "random_crop":
            pkg.layers.random_crop(_data(pkg, "x", (3, 8, 8)), [6, 6],
                                   seed=7)
        elif name == "load":
            v = pkg.default_main_program().global_block().create_var(
                name="w", shape=(2, 3), dtype="float32")
            pkg.layers.load(v, "/no/such/file")
        else:
            pkg.layers.get_places(device_count=2, device_type="CPU")
    return build


@pytest.mark.parametrize("name", ["cos_sim", "random_crop", "load",
                                  "get_places"])
def test_builder_emits_reference_program(name):
    assert _builder_program(tf, _builder(name)) == \
        _builder_program(rf, _builder(name))
