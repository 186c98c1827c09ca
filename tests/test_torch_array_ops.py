"""The tensor-array and LoD ops of ``DynamicRNN`` / ``StaticRNN`` /
``IfElse`` (``paddle_tpu_torch/ops/array_ops.py``) against the JAX
package, on the CPU, forward and grad: each small program is built by the
same calls in both packages (the same Program) and run on the same feed;
every fetched value, array length and LoD within rtol 1e-6, and the input
grads ``append_backward`` gives within rtol 1e-6.  The ragged LoD holds a
sequence of length 1; ``lod_tensor_to_array`` -> ``array_to_lod_tensor``
gives the input back exactly, with its LoD."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework

RTOL = 1e-6
LENS = [3, 1, 4, 2]


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _sig(program):
    return [(b.idx, b.parent_idx,
             [(op.type, dict(op.inputs), dict(op.outputs)) for op in b.ops])
            for b in program.blocks]


def _np(v):
    if hasattr(v, "lod") and callable(v.lod):
        return np.asarray(v), tuple(tuple(int(o) for o in lvl)
                                    for lvl in v.lod())
    if isinstance(v, torch.Tensor):
        return v.detach().numpy(), ()
    return np.asarray(v), ()


def _idx(layers, k):
    i = layers.fill_constant(shape=[1], dtype="int64", value=k)
    i.stop_gradient = True
    return i


def _loss(fluid, outs):
    """The sum of each output squared, and its backward."""
    layers = fluid.layers
    terms = [layers.reduce_sum(layers.elementwise_mul(o, o)) for o in outs]
    loss = terms[0]
    for t in terms[1:]:
        loss = layers.elementwise_add(loss, t)
    fluid.append_backward(loss)
    return loss


def _ragged(fluid, dim=3, seed=0):
    x = np.random.RandomState(seed).randn(sum(LENS), dim).astype(np.float32)
    return fluid.create_lod_tensor(x, [LENS])


def build_lod_round_trip(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[3], dtype="float32", lod_level=1)
    x.stop_gradient = False
    table = layers.lod_rank_table(x)
    arr = layers.lod_tensor_to_array(x, table)
    step1 = layers.array_read(arr, _idx(layers, 1))
    step3 = layers.array_read(arr, _idx(layers, 3))
    back = layers.array_to_lod_tensor(arr, table)
    loss = _loss(fluid, [back, layers.scale(step1, 3.0), step3])
    fetches = [back, step1, step3, layers.array_length(arr),
               layers.max_sequence_len(table), loss]
    return fetches + ["x@GRAD"], {"x": _ragged(fluid)}


def build_shrink_reorder(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[3], dtype="float32", lod_level=1)
    x.stop_gradient = False
    m = layers.data("m", shape=[4, 3], dtype="float32",
                    append_batch_size=False)
    m.stop_gradient = False
    table = layers.lod_rank_table(x)
    rx = layers.reorder_lod_tensor_by_rank(x, table)
    rm = layers.reorder_lod_tensor_by_rank(m, table)
    shrunk = layers.shrink_memory(rm, _idx(layers, 2), table)
    loss = _loss(fluid, [rx, shrunk])
    mv = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    return ([rx, rm, shrunk, loss, "x@GRAD", "m@GRAD"],
            {"x": _ragged(fluid), "m": mv})


def build_write_read(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[2, 3], dtype="float32",
                    append_batch_size=False)
    x.stop_gradient = False
    i0, i2 = _idx(layers, 0), _idx(layers, 2)
    arr = layers.array_write(x, i0)
    layers.array_write(layers.scale(x, scale=2.0), i2, array=arr)
    r0 = layers.array_read(arr, i0)
    r2 = layers.array_read(arr, i2)
    loss = _loss(fluid, [layers.elementwise_mul(r0, r2)])
    xv = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    return [r0, r2, layers.array_length(arr), layers.is_empty(arr), loss,
            "x@GRAD"], {"x": xv}


def build_stack_unstack(fluid):
    """``tensor_array_unstack`` / ``tensor_array_stack`` (StaticRNN's ops,
    no builder of their own) appended to the block directly."""
    from importlib import import_module

    core = import_module(fluid.__name__ + ".core")
    layers = fluid.layers
    x = layers.data("x", shape=[3, 2, 4], dtype="float32",
                    append_batch_size=False)
    x.stop_gradient = False
    block = fluid.default_main_program().current_block()
    arr = block.create_var(name="unstacked", dtype="float32",
                           type=core.VarType.LOD_TENSOR_ARRAY)
    block.append_op(type="tensor_array_unstack", inputs={"X": [x]},
                    outputs={"Out": [arr]})
    mid = layers.array_read(arr, _idx(layers, 1))
    y = block.create_var(name="stacked", dtype="float32", shape=(3, 2, 4))
    block.append_op(type="tensor_array_stack", inputs={"X": [arr]},
                    outputs={"Out": [y]})
    loss = _loss(fluid, [y, mid])
    xv = np.random.RandomState(3).randn(3, 2, 4).astype(np.float32)
    return [y, mid, loss, "x@GRAD"], {"x": xv}


def build_split_merge(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[5, 2], dtype="float32",
                    append_batch_size=False)
    x.stop_gradient = False
    mask = layers.data("mask", shape=[5, 1], dtype="bool",
                       append_batch_size=False)
    ie = layers.IfElse(mask)
    with ie.true_block():
        ie.output(layers.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(layers.scale(ie.input(x), scale=-3.0))
    out = ie()
    loss = _loss(fluid, [out])
    xv = np.random.RandomState(4).randn(5, 2).astype(np.float32)
    mv = np.array([[True], [False], [False], [True], [False]])
    return [out, loss, "x@GRAD"], {"x": xv, "mask": mv}


CASES = {"lod_round_trip": build_lod_round_trip,
         "shrink_reorder": build_shrink_reorder,
         "write_read": build_write_read, "stack_unstack": build_stack_unstack,
         "split_merge": build_split_merge}


def _run(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetches, feed = build(fluid)
    names = [f if isinstance(f, str) else f.name for f in fetches]
    exe = fluid.Executor(fluid.CPUPlace())
    out = exe.run(main, feed=feed, fetch_list=names, return_numpy=False)
    return main, [_np(v) for v in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_array_op_matches_reference(case):
    rmain, want = _run(rf, CASES[case])
    pmain, got = _run(tf, CASES[case])
    assert _sig(pmain) == _sig(rmain)
    for (g, g_lod), (w, w_lod) in zip(got, want):
        assert g_lod == w_lod
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)


def test_lod_round_trip_is_exact():
    """``array_to_lod_tensor(lod_tensor_to_array(x))`` is ``x`` with its
    LoD; each step's batch holds the sequences still running, longest
    first."""
    _, got = _run(tf, build_lod_round_trip)
    x = np.asarray(_ragged(tf))
    (back, back_lod), (step1, _), (step3, _), (n, _), (mx, _) = got[:5]
    np.testing.assert_array_equal(back, x)
    assert back_lod == ((0, 3, 4, 8, 10),)
    # rank order: lengths 4, 3, 2, 1 -> sequences 2, 0, 3, 1
    np.testing.assert_array_equal(step1, x[[5, 1, 9]])
    np.testing.assert_array_equal(step3, x[[7]])
    assert int(n[0]) == 4 and int(mx[0]) == 4
