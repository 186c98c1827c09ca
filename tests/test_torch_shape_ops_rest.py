"""The port's remaining shape ops (``paddle_tpu_torch/ops/shape_ops.py``)
against the JAX package's, on the CPU, through the one-op harness of
``test_torch_sequence_ops.py``: every output within fp32 rtol 1e-5 /
atol 1e-6 (integer outputs equal), and the input grads (from
``append_backward`` of ``sum(out * c)``) within the same tolerance.

The resizes go both ways (``jax.image.resize``: half-pixel centres, a
bilinear shrink antialiased, nearest picking ``floor((i + 0.5) * in /
out)``); ``pad2d`` runs its three modes in both layouts; ``scatter``'s
ids are unique where it overwrites (which of two equal ids wins is not
fixed in either package) and repeat where it adds.  The builders emit the
reference's Program.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_activation_ops_rest import _builder_program, _data, _x
from test_torch_sequence_ops import _build, _run, compare_with_reference, feed


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _cases():
    rng = np.random.RandomState(3)
    x3 = _x(1, shape=(2, 3, 4))
    cases = {
        "reshape2": ("reshape2", {"X": [feed(x3, None, True)]},
                     {"shape": [0, -1]}, ("Out", "XShape")),
        "transpose2": ("transpose2", {"X": [feed(x3, None, True)]},
                       {"axis": [2, 0, 1]}, ("Out", "XShape")),
        "squeeze_axes": ("squeeze", {"X": [feed(_x(2, shape=(2, 1, 3, 1)),
                                                None, True)]},
                         {"axes": [1, -1, 2]}, ("Out",)),
        "squeeze_all": ("squeeze", {"X": [feed(_x(3, shape=(1, 3, 1)),
                                               None, True)]},
                        {"axes": []}, ("Out",)),
        "unsqueeze": ("unsqueeze", {"X": [feed(x3, None, True)]},
                      {"axes": [3, 0]}, ("Out",)),
        "stack": ("stack", {"X": [feed(_x(4), None, True),
                                  feed(_x(5), None, True),
                                  feed(_x(6), None, True)]},
                  {"axis": 1}, ("Y",)),
        "expand": ("expand", {"X": [feed(_x(7, shape=(2, 1, 3)), None,
                                         True)]},
                   {"expand_times": [2, 4, 1]}, ("Out",)),
        "expand_as": ("expand_as", {"X": [feed(_x(8, shape=(2, 3)), None,
                                               True)],
                                    "Y": [feed(_x(9, shape=(4, 6)))]},
                      {}, ("Out",)),
        "tile": ("tile", {"X": [feed(_x(10, shape=(2, 3)), None, True)]},
                 {"repeat_times": [3, 1, 2]}, ("Out",)),
        "scatter_overwrite": (
            "scatter", {"X": [feed(_x(11, shape=(6, 3)), None, True)],
                        "Ids": [feed(np.array([4, 0, 2], np.int64))],
                        "Updates": [feed(_x(12, shape=(3, 3)), None, True)]},
            {"overwrite": True}, ("Out",)),
        "scatter_add": (
            "scatter", {"X": [feed(_x(13, shape=(6, 3)), None, True)],
                        "Ids": [feed(np.array([4, 0, 4, 1], np.int64))],
                        "Updates": [feed(_x(14, shape=(4, 3)), None, True)]},
            {"overwrite": False}, ("Out",)),
        "pad": ("pad", {"X": [feed(x3, None, True)]},
                {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": -0.5},
                ("Out",)),
        "pad_constant_like": (
            "pad_constant_like", {"X": [feed(_x(15, shape=(4, 5)))],
                                  "Y": [feed(_x(16, shape=(2, 3)), None,
                                             True)]},
            {"pad_value": 1.5}, ("Out",)),
        "crop": ("crop", {"X": [feed(_x(17, shape=(3, 5, 6)), None, True)]},
                 {"offsets": [1, 0, 2], "shape": [2, 3, 4]}, ("Out",)),
        "reverse": ("reverse", {"X": [feed(x3, None, True)]},
                    {"axis": [0, 2]}, ("Out",)),
        "shape": ("shape", {"Input": [feed(x3)]}, {}, ("Out",)),
        "multiplex": (
            "multiplex", {"X": [feed(_x(18, shape=(4, 3)), None, True),
                                feed(_x(19, shape=(4, 3)), None, True),
                                feed(_x(20, shape=(4, 3)), None, True)],
                          "Ids": [feed(np.array([[2], [0], [2], [1]],
                                                np.int32))]},
            {}, ("Out",)),
        "where": ("where", {"Condition": [feed(rng.rand(3, 4) > 0.5)],
                            "X": [feed(_x(21, shape=(3, 4)), None, True)],
                            "Y": [feed(_x(22, shape=(3, 4)), None, True)]},
                  {}, ("Out",)),
    }
    img = _x(23, shape=(2, 3, 5, 7))
    for mode in ("constant", "reflect", "edge"):
        for fmt, arr in (("NCHW", img), ("NHWC", img.transpose(0, 2, 3, 1))):
            cases[f"pad2d_{mode}_{fmt}"] = (
                "pad2d", {"X": [feed(np.ascontiguousarray(arr), None, True)]},
                {"paddings": [1, 2, 3, 1], "mode": mode, "pad_value": 0.25,
                 "data_format": fmt}, ("Out",))
    for op in ("bilinear_interp", "nearest_interp"):
        for tag, (h, w) in (("down", (2, 3)), ("up", (9, 12)),
                            ("mixed", (3, 11)), ("5to3", (3, 3))):
            src = img if tag != "5to3" else _x(24, shape=(1, 2, 5, 5))
            cases[f"{op}_{tag}"] = (op, {"X": [feed(src, None, True)]},
                                    {"out_h": h, "out_w": w}, ("Out",))
    return cases


CASES = _cases()


# a resize output is a weighted sum of inputs whose weights each package
# computes in fp32 in its own order (the jitted reference and the port part
# by up to 1.7e-6 at inputs of magnitude ~6, both ~3e-6 from a float64
# resize): held within 1e-6 of the input's largest magnitude (plus rtol
# 1e-5), not of each output value
def _tol(name):
    if "interp" not in name:
        return None
    x = CASES[name][1]["X"][0][1]
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(x).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_shape_op_matches_reference(name):
    compare_with_reference(CASES[name], _tol(name))


def test_expand_as_takes_target_tensor():
    """The port tiles ``X`` to ``target_tensor``'s shape; the reference
    raises on that slot (``ctx.input("target_tensor") or ...`` asks an
    array for its truth value), so the parity case feeds ``Y``: a fault of
    the reference (ROADMAP queue 3), held here."""
    x, t = _x(27, shape=(2, 3)), _x(28, shape=(4, 6))
    case = ("expand_as", {"X": [feed(x)], "target_tensor": [feed(t)]}, {},
            ("Out",))
    main, feeds, outs, _ = _build(tf, case)
    np.testing.assert_array_equal(np.asarray(_run(tf, main, feeds, outs)[0]),
                                  np.tile(x, (2, 2)))
    main, feeds, outs, _ = _build(rf, case)
    with pytest.raises(Exception, match="truth value"):
        _run(rf, main, feeds, outs)


def test_unstack_matches_reference():
    """``unstack``'s list output, one slot a piece (the harness names one
    output a slot)."""
    x = _x(25, shape=(3, 2, 4))
    got = {}
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            v = pkg.layers.data("x", shape=[2, 4], dtype="float32")
            v.stop_gradient = False
            outs = pkg.layers.unstack(v, axis=1)
            loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(
                outs[0], pkg.layers.scale(outs[1], scale=3.0)))
            pkg.append_backward(loss)
        got[pkg] = pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=outs + ["x@GRAD"],
            scope=pkg.Scope())
    for r, p in zip(got[rf], got[tf]):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def _resize(op, x, h, w):
    case = (op, {"X": [feed(x)]}, {"out_h": h, "out_w": w}, ("Out",))
    main, feeds, outs, _ = _build(tf, case)
    return np.asarray(_run(tf, main, feeds, outs)[0])


def test_resize_follows_jax_image_resize():
    """Nearest at 5 -> 3 picks rows 0, 2 and 4 (half-pixel; a plain
    nearest would pick 0, 1 and 3); bilinear at 4 -> 2 averages over the
    shrunk triangle (3.5714... at the first pixel of 0..3, not the plain
    bilinear's 0.5)."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5, 1)
    np.testing.assert_array_equal(_resize("nearest_interp", x, 3, 1).reshape(
        -1), [0, 2, 4])
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got = _resize("bilinear_interp", x, 2, 2).reshape(-1)
    np.testing.assert_allclose(got[0], 3.5714285, rtol=1e-6)


def test_pad2d_refuses_an_unknown_mode():
    case = ("pad2d", {"X": [feed(_x(26, shape=(1, 1, 3, 3)))]},
            {"paddings": [1, 1, 1, 1], "mode": "circular"}, ("Out",))
    main, feeds, outs, _ = _build(tf, case)
    with pytest.raises(ValueError, match="mode"):
        _run(tf, main, feeds, outs)


BUILDERS = {
    "expand": lambda pkg: pkg.layers.expand(_data(pkg), [2, 3]),
    "stack": lambda pkg: pkg.layers.stack([_data(pkg), _data(pkg, "y")],
                                          axis=1),
    "unstack": lambda pkg: pkg.layers.unstack(_data(pkg), axis=1),
    "squeeze": lambda pkg: pkg.layers.squeeze(
        _data(pkg, shape=(1, 3, 1)), axes=[0, 2]),
    "unsqueeze": lambda pkg: pkg.layers.unsqueeze(_data(pkg), axes=[0, 3]),
    "pad": lambda pkg: pkg.layers.pad(_data(pkg), [0, 1, 2, 3, 0, 0], 0.5),
    "pad2d": lambda pkg: pkg.layers.pad2d(
        _data(pkg, shape=(3, 8, 8)), [1, 2, 0, 1], "reflect"),
    "pad2d_nhwc": lambda pkg: pkg.layers.pad2d(
        _data(pkg, shape=(8, 8, 3)), [1, 1, 1, 1], "edge",
        data_format="NHWC"),
    "pad_constant_like": lambda pkg: pkg.layers.pad_constant_like(
        _data(pkg, shape=(5, 6)), _data(pkg, "y"), 1.0),
    "crop": lambda pkg: pkg.layers.crop(_data(pkg, shape=(5, 6)),
                                        shape=[2, 2, 3], offsets=[0, 1, 2]),
    "reverse": lambda pkg: pkg.layers.reverse(_data(pkg), 1),
    "scatter": lambda pkg: pkg.layers.scatter(
        _data(pkg), _data(pkg, "i", (1,), "int64"), _data(pkg, "u"),
        overwrite=False),
    "shape": lambda pkg: pkg.layers.shape(_data(pkg)),
    "multiplex": lambda pkg: pkg.layers.multiplex(
        [_data(pkg), _data(pkg, "y")], _data(pkg, "i", (1,), "int32")),
    "image_resize": lambda pkg: pkg.layers.image_resize(
        _data(pkg, shape=(3, 8, 10)), scale=0.5),
    "image_resize_nearest": lambda pkg: pkg.layers.image_resize(
        _data(pkg, shape=(3, 8, 10)), out_shape=[5, 4], resample="NEAREST"),
    "resize_bilinear": lambda pkg: pkg.layers.resize_bilinear(
        _data(pkg, shape=(3, 8, 10)), out_shape=[16, 20]),
    "image_resize_short": lambda pkg: pkg.layers.image_resize_short(
        _data(pkg, shape=(3, 9, 14)), 6),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_emits_reference_program(name):
    """The same builder call gives the same ops, slots, attrs, variable
    names, shapes and dtypes in both packages."""
    assert _builder_program(tf, BUILDERS[name]) == \
        _builder_program(rf, BUILDERS[name])
