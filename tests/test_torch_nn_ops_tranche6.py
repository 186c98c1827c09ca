"""The port's convolutions, norms, 3-D and indexed pools, unpool,
scale_sub_region and print (``paddle_tpu_torch/ops/nn_ops.py``,
``misc_ops.py``) against the JAX package's, on the CPU, through the one-op
harness of ``test_torch_sequence_ops.py``: every output within fp32 rtol
1e-5 / atol 1e-6 (integer outputs equal), and the input grads (from
``append_backward`` of ``sum(out * c)``) within the same tolerance.

The convolutions run at odd sizes with strides, paddings, dilations and
groups; their grads are explicit (no forward convolution runs in the
backward).  The max pools' inputs are tie-free, so ``Mask`` and the
unpool that reads it are exact; one unpool's 3 x 3 / stride 2 windows
overlap, so two windows' maxima land on one position and add (a
writing unpool such as ``F.max_unpool2d`` would keep one).  ``print``'s
text is captured and equal between the packages.  The builders emit the
reference's Program.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import nn_ops
from test_torch_activation_ops_rest import _builder_program, _data
from test_torch_sequence_ops import _build, _run, compare_with_reference, feed


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _n(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _distinct(seed, *shape):
    """A tie-free input: a shuffled ramp."""
    vals = np.linspace(-3.0, 3.0, int(np.prod(shape)), dtype=np.float32)
    return np.random.RandomState(seed).permutation(vals).reshape(shape)


def _conv(op, x, w, **attrs):
    """A convolution case; inputs at a quarter of unit scale, so the
    grads' sums (tens of products) stay near unit size for the atol."""
    return (op, {"Input": [feed(x / 4, None, True)],
                 "Filter": [feed(w / 4, None, True)]}, attrs, ("Output",))


def _pool_mask(x, k, s, p=0):
    """The flat argmax positions of a 2-D max pool of ``x``."""
    return F.max_pool2d(torch.from_numpy(x), k, s, p,
                        return_indices=True)[1].numpy()


def _cases():
    cases = {
        "conv3d": _conv("conv3d", _n(1, 2, 4, 5, 6, 7), _n(2, 6, 2, 3, 2, 3),
                        strides=[1, 2, 1], paddings=[1, 0, 2],
                        dilations=[1, 1, 2], groups=2),
        "conv3d_plain": _conv("conv3d", _n(3, 1, 3, 4, 5, 5),
                              _n(4, 2, 3, 3, 3, 3), strides=[1, 1, 1],
                              paddings=[1, 1, 1], dilations=[1, 1, 1]),
        "depthwise_conv2d": _conv("depthwise_conv2d", _n(5, 2, 4, 9, 7),
                                  _n(6, 4, 1, 3, 3), strides=[2, 1],
                                  paddings=[1, 1], groups=0),
        "depthwise_conv2d_multiplier": _conv(
            "depthwise_conv2d", _n(7, 2, 3, 8, 9), _n(8, 6, 1, 3, 2),
            strides=[1, 2], paddings=[2, 0], dilations=[2, 1], groups=3),
        "conv2d_transpose": _conv("conv2d_transpose", _n(9, 2, 4, 5, 7),
                                  _n(10, 4, 3, 3, 4), strides=[2, 3],
                                  paddings=[1, 2], dilations=[2, 1],
                                  groups=2),
        "conv2d_transpose_dcgan": _conv(
            "conv2d_transpose", _n(11, 2, 6, 4, 4), _n(12, 6, 5, 4, 4),
            strides=[2, 2], paddings=[1, 1]),
        "conv3d_transpose": _conv("conv3d_transpose", _n(13, 1, 4, 3, 5, 4),
                                  _n(14, 4, 3, 2, 3, 3), strides=[2, 1, 2],
                                  paddings=[0, 1, 1], dilations=[1, 2, 1],
                                  groups=2),
        "depthwise_conv2d_transpose": _conv(
            "depthwise_conv2d_transpose", _n(15, 2, 3, 5, 6),
            _n(16, 3, 1, 4, 4), strides=[2, 2], paddings=[1, 1], groups=0),
        "depthwise_conv2d_transpose_odd": _conv(
            "depthwise_conv2d_transpose", _n(17, 1, 4, 5, 3),
            _n(18, 4, 2, 3, 2), strides=[3, 1], paddings=[1, 0],
            dilations=[1, 2], groups=4),
        "lrn_op_default_k": ("lrn", {"X": [feed(_n(19, 2, 7, 5, 5), None,
                                                True)]},
                             {"n": 5, "alpha": 0.5, "beta": 0.75},
                             ("Out", "MidOut")),
        "lrn_even_n": ("lrn", {"X": [feed(_n(20, 2, 6, 3, 4), None, True)]},
                       {"n": 4, "k": 1.0, "alpha": 1e-2, "beta": 0.5},
                       ("Out", "MidOut")),
        "maxout": ("maxout", {"X": [feed(_distinct(21, 2, 6, 3, 4), None,
                                         True)]}, {"groups": 3}, ("Out",)),
        "group_norm": ("group_norm",
                       {"X": [feed(_n(22, 2, 6, 3, 5, scale=2.0), None,
                                   True)],
                        "Scale": [feed(_n(23, 6), None, True)],
                        "Bias": [feed(_n(24, 6), None, True)]},
                       {"groups": 3, "epsilon": 1e-5},
                       ("Y", "Mean", "Variance")),
        "group_norm_no_affine": ("group_norm",
                                 {"X": [feed(_n(25, 3, 4, 2, 3, 2), None,
                                             True)]},
                                 {"groups": 2}, ("Y", "Mean", "Variance")),
        "spp_max": ("spp", {"X": [feed(_distinct(26, 2, 3, 13, 11), None,
                                       True)]},
                    {"pyramid_height": 3, "pooling_type": "max"}, ("Out",)),
        "spp_avg": ("spp", {"X": [feed(_n(27, 2, 3, 5, 7), None, True)]},
                    {"pyramid_height": 3, "pooling_type": "avg"}, ("Out",)),
        "max_pool2d_with_index": (
            "max_pool2d_with_index",
            {"X": [feed(_distinct(32, 2, 3, 7, 9), None, True)]},
            {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
            ("Out", "Mask")),
        "max_pool3d_with_index": (
            "max_pool3d_with_index",
            {"X": [feed(_distinct(33, 1, 2, 4, 6, 5), None, True)]},
            {"ksize": [1, 2, 2], "strides": [1, 2, 2],
             "paddings": [0, 1, 0]}, ("Out", "Mask")),
        "scale_sub_region": (
            "scale_sub_region",
            {"X": [feed(_n(36, 2, 4, 5, 6), None, True)],
             "Indices": [feed(np.array([[1, 3, 2, 4, 1, 6],
                                        [2, 2, 1, 5, 3, 3]], np.int32))]},
            {"scale": 2.5}, ("Out",)),
    }
    for ptype, exclusive, pads in (("max", True, [1, 1, 0]),
                                   ("avg", True, [1, 1, 0]),
                                   ("avg", False, [1, 1, 0]),
                                   ("avg", True, [0, 0, 0])):
        name = f"pool3d_{ptype}_{'excl' if exclusive else 'incl'}" \
               f"{'_pad' if any(pads) else ''}"
        cases[name] = ("pool3d", {"X": [feed(_distinct(28, 2, 3, 5, 6, 7),
                                             None, True)]},
                       {"pooling_type": ptype, "ksize": [2, 3, 2],
                        "strides": [1, 2, 2], "paddings": pads,
                        "exclusive": exclusive}, ("Out",))
    cases["pool3d_global"] = ("pool3d", {"X": [feed(_n(29, 2, 3, 3, 4, 2),
                                                    None, True)]},
                              {"pooling_type": "avg", "ksize": [1, 1, 1],
                               "global_pooling": True}, ("Out",))
    x = _distinct(34, 2, 3, 9, 9)
    pooled = F.max_pool2d(torch.from_numpy(x), 3, 2).numpy()
    cases["unpool_overlapping"] = (
        "unpool", {"X": [feed(pooled, None, True)],
                   "Indices": [feed(_pool_mask(x, 3, 2))]},
        {"ksize": [3, 3], "strides": [2, 2], "unpooling_type": "max"},
        ("Out",))
    x = _distinct(35, 1, 2, 6, 8)
    cases["unpool_sized"] = (
        "unpool", {"X": [feed(F.max_pool2d(torch.from_numpy(x), 2, 2).numpy(),
                              None, True)],
                   "Indices": [feed(_pool_mask(x, 2, 2))]},
        {"ksize": [2, 2], "strides": [2, 2], "unpooled_height": 6,
         "unpooled_width": 8}, ("Out",))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    compare_with_reference(CASES[name])


def test_overlapping_unpool_adds():
    """Where two windows' maxima share a position the output holds their
    sum (a writing unpool would hold one of them)."""
    case = CASES["unpool_overlapping"]
    pooled, idx = case[1]["X"][0][1], case[1]["Indices"][0][1]
    main, feeds, outs, _ = _build(tf, case)
    out = np.asarray(_run(tf, main, feeds, outs)[0])
    shared = 0
    for n in range(idx.shape[0]):
        for c in range(idx.shape[1]):
            flat, vals = idx[n, c].reshape(-1), pooled[n, c].reshape(-1)
            for v in np.unique(flat):
                hits = vals[flat == v]
                if len(hits) > 1:
                    shared += 1
                    assert out[n, c].reshape(-1)[v] == pytest.approx(
                        hits.sum(), rel=1e-6)
    assert shared


CONV_GRAD_CASES = ["conv3d", "depthwise_conv2d", "conv2d_transpose",
                   "conv3d_transpose", "depthwise_conv2d_transpose"]


@pytest.mark.parametrize("name", CONV_GRAD_CASES)
def test_conv_grad_runs_no_forward_convolution(name, monkeypatch):
    """The backward of a program with one convolution runs no convolution
    forward: only the op itself calls one."""
    calls = []
    for key, conv in list(nn_ops._CONVS.items()):
        def counted(*args, _conv=conv, **kwargs):
            calls.append(1)
            return _conv(*args, **kwargs)
        monkeypatch.setitem(nn_ops._CONVS, key, counted)
    case = CASES[name]
    rmain, rfeeds, routs, _ = _build(rf, case)
    shape = np.asarray(_run(rf, rmain, rfeeds, routs)[0]).shape
    w = {"Output": np.random.RandomState(2).standard_normal(shape).astype(
        np.float32)}
    main, feeds, _, grads = _build(tf, case, w)
    assert sorted(grads) == sorted(["input_0@GRAD", "filter_0@GRAD"])
    assert f"{case[0]}_grad" in [op.type for op in main.global_block().ops]
    got = _run(tf, main, feeds, grads)
    assert len(calls) == 1
    assert all(np.isfinite(np.asarray(g)).all() for g in got)


def _print_text(pkg, x, **kwargs):
    """What a program that prints ``x`` (and takes its grad) prints over
    three runs."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        v = pkg.layers.data(name="x", shape=list(x.shape[1:]),
                            dtype="float32")
        v.stop_gradient = False
        y = pkg.layers.Print(v, **kwargs)
        loss = pkg.layers.mean(pkg.layers.scale(y, 2.0))
        pkg.append_backward(loss)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    buf = io.StringIO()
    with redirect_stdout(buf):
        for _ in range(3):
            grad = exe.run(main, feed={"x": x}, fetch_list=["x@GRAD"],
                           scope=scope)[0]
        if pkg is rf:
            import jax

            jax.effects_barrier()
    return buf.getvalue(), np.asarray(grad)


@pytest.mark.parametrize("kwargs", [
    dict(message="act", summarize=5),
    dict(message="once", first_n=1, summarize=3),
    dict(message="bare", print_tensor_shape=False, print_tensor_type=False)],
    ids=["summarize", "first_n", "no_shape_dtype"])
def test_print_text_matches_reference(kwargs):
    x = _n(40, 2, 3, 4)
    ref_text, ref_grad = _print_text(rf, x, **kwargs)
    port_text, port_grad = _print_text(tf, x, **kwargs)
    assert port_text == ref_text
    assert kwargs["message"] in port_text
    np.testing.assert_allclose(port_grad, ref_grad, rtol=1e-6)


BUILDERS = {
    "conv3d": lambda pkg: pkg.layers.conv3d(
        _data(pkg, shape=(3, 5, 6, 7)), 4, [2, 3, 2], stride=[1, 2, 1],
        padding=1, dilation=[1, 1, 2], groups=1, act="relu"),
    "conv2d_transpose": lambda pkg: pkg.layers.conv2d_transpose(
        _data(pkg, shape=(4, 5, 7)), 6, filter_size=4, stride=2, padding=1,
        groups=2),
    "conv2d_transpose_output_size": lambda pkg: pkg.layers.conv2d_transpose(
        _data(pkg, shape=(4, 5, 7)), 3, output_size=[11, 15], stride=2,
        padding=[1, 0], bias_attr=False, act="tanh"),
    "conv3d_transpose": lambda pkg: pkg.layers.conv3d_transpose(
        _data(pkg, shape=(4, 3, 5, 4)), 2, filter_size=[2, 3, 3],
        stride=[2, 1, 2], padding=[0, 1, 1], dilation=[1, 2, 1]),
    "conv3d_transpose_output_size": lambda pkg: pkg.layers.conv3d_transpose(
        _data(pkg, shape=(4, 3, 5, 4)), 2, output_size=[7, 9, 8], stride=2),
    "group_norm": lambda pkg: pkg.layers.group_norm(
        _data(pkg, shape=(6, 3, 5)), 3, act="relu"),
    "group_norm_no_affine": lambda pkg: pkg.layers.group_norm(
        _data(pkg, shape=(4, 3, 5)), 2, param_attr=False, bias_attr=False),
    "lrn": lambda pkg: pkg.layers.lrn(_data(pkg, shape=(7, 5, 5)), n=3),
    "maxout": lambda pkg: pkg.layers.maxout(_data(pkg, shape=(6, 3, 4)), 2),
    "pool3d": lambda pkg: pkg.layers.pool3d(
        _data(pkg, shape=(3, 5, 6, 7)), [2, 3, 2], "avg", [1, 2, 2],
        [1, 1, 0], exclusive=False),
    "pool3d_ceil": lambda pkg: pkg.layers.pool3d(
        _data(pkg, shape=(3, 5, 6, 7)), 2, pool_stride=2, ceil_mode=True),
    "pool3d_global": lambda pkg: pkg.layers.pool3d(
        _data(pkg, shape=(3, 5, 6, 7)), global_pooling=True),
    "Print": lambda pkg: pkg.layers.Print(_data(pkg), first_n=2,
                                          message="m", summarize=4),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_emits_reference_program(name):
    """The same builder call gives the same ops, slots, attrs, variable
    names, shapes and dtypes in both packages."""
    assert _builder_program(tf, BUILDERS[name]) == \
        _builder_program(rf, BUILDERS[name])
