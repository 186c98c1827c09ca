"""The port's remaining math and reduce ops (``paddle_tpu_torch/ops/
math_ops.py``, ``reduce_ops.py``) against the JAX package's, on the CPU,
through the one-op harness of ``test_torch_sequence_ops.py``: every
output within fp32 rtol 1e-5 / atol 1e-6 (integer and bool outputs
equal), and the input grads (from ``append_backward`` of ``sum(out *
c)``) within the same tolerance.

The inputs hold ``clip``'s exact bounds (half the grad there),
``maximum`` / ``minimum`` and ``reduce_max`` / ``reduce_min`` ties (the
grad split evenly), zeros for ``sign`` and ``reduce_prod``, negative
operands of ``elementwise_mod`` / ``floordiv`` in float and int (Python's
signs), ``clip_by_norm`` on both sides of its bound, inf and NaN for the
finiteness checks, and ties for ``argsort`` (stable), ``arg_max`` and
``arg_min`` (the first).  The builders emit the reference's Program.
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


def _ties(seed, shape=(3, 5)):
    """Small integers as floats: many equal values, so ties everywhere."""
    return np.random.RandomState(seed).randint(-2, 3, shape).astype(
        np.float32)


def _mod_operands(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randint(-9, 10, (4, 5)).astype(dtype)
    y = rng.choice([-4, -3, -2, 2, 3, 5], (4, 5)).astype(dtype)
    if dtype == np.float32:
        x = x + rng.uniform(-0.4, 0.4, (4, 5)).astype(np.float32)
        x[0, :2] = [4.0, -4.0]  # exact multiples of -2 and 2
        y[0, :2] = [-2.0, 2.0]
    return x, y


def _cases():
    cases = {}
    clip_x = _x(1, 0.5, -0.5, 0.0, 0.7, -0.7)
    cases["clip"] = ("clip", {"X": [feed(clip_x, None, True)]},
                     {"min": -0.5, "max": 0.5}, ("Out",))
    big = _x(2, scale=3.0)
    for name, max_norm in (("clip_by_norm_clipped", 1.0),
                           ("clip_by_norm_unclipped", 1e3)):
        cases[name] = ("clip_by_norm", {"X": [feed(big, None, True)]},
                       {"max_norm": max_norm}, ("Out",))
    inf = _x(3, np.inf)
    nan = _x(4, np.nan)
    fine = _x(5)
    for op in ("isfinite", "has_inf", "has_nan"):
        for tag, arr in (("inf", inf), ("nan", nan), ("finite", fine)):
            cases[f"{op}_{tag}"] = (op, {"X": [feed(arr)]}, {}, ("Out",))
    cases["sign"] = ("sign", {"X": [feed(_x(6, 0.0, -0.0), None, True)]}, {},
                     ("Out",))
    a, b = _ties(7), _ties(8)
    for op in ("maximum", "minimum"):
        cases[op] = (op, {"X": [feed(a, None, True)],
                          "Y": [feed(b, None, True)]}, {}, ("Out",))
    cases["dot"] = ("dot", {"X": [feed(_x(9), None, True)],
                            "Y": [feed(_x(10), None, True)]}, {}, ("Out",))
    for op in ("elementwise_mod", "elementwise_floordiv"):
        x, y = _mod_operands(11, np.float32)
        cases[f"{op}_float"] = (op, {"X": [feed(x, None, True)],
                                     "Y": [feed(y, None, True)]}, {},
                                ("Out",))
        x, y = _mod_operands(12, np.int64)
        cases[f"{op}_int"] = (op, {"X": [feed(x)], "Y": [feed(y)]}, {},
                              ("Out",))
        x, y = _mod_operands(13, np.float32)
        cases[f"{op}_broadcast"] = (op, {"X": [feed(x, None, True)],
                                         "Y": [feed(y[0], None, True)]},
                                    {"axis": -1}, ("Out",))
    t = _ties(14, (3, 4, 5))
    for op in ("reduce_max", "reduce_min", "reduce_prod"):
        for tag, attrs in (("all", {"reduce_all": True}),
                           ("dim1", {"dim": [1]}),
                           ("dims02_keep", {"dim": [0, 2], "keep_dim": True}),
                           ("neg", {"dim": [-1]})):
            cases[f"{op}_{tag}"] = (op, {"X": [feed(t, None, True)]}, attrs,
                                    ("Out",))
    c = _x(15, shape=(3, 4, 5))
    for tag, attrs in (("last", {}), ("axis1", {"axis": 1}),
                       ("exclusive", {"axis": 1, "exclusive": True}),
                       ("reverse", {"axis": 0, "reverse": True}),
                       ("exclusive_reverse", {"axis": -1, "exclusive": True,
                                              "reverse": True})):
        cases[f"cumsum_{tag}"] = ("cumsum", {"X": [feed(c, None, True)]},
                                  attrs, ("Out",))
    cases["cumsum_int"] = ("cumsum", {"X": [feed(
        np.arange(12, dtype=np.int64).reshape(3, 4))]}, {"axis": 1},
        ("Out",))
    for op in ("arg_max", "arg_min"):
        for axis in (0, -1):
            cases[f"{op}_{axis}"] = (op, {"X": [feed(_ties(16, (4, 6)))]},
                                     {"axis": axis}, ("Out",))
    for axis in (0, -1):  # no grad (X is a no-grad input in both)
        cases[f"argsort_{axis}"] = ("argsort", {"X": [feed(_ties(17, (5, 6)))]},
                                    {"axis": axis}, ("Out", "Indices"))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_reduce_op_matches_reference(name):
    compare_with_reference(CASES[name])


def _port_grads(case, weights):
    main, feeds, _, grads = _build(tf, case, weights)
    return [np.asarray(g) for g in _run(tf, main, feeds, grads)]


def test_ties_split_the_grad():
    """``clip`` gives 0.5 at a bound, ``maximum`` 0.5 to each of two
    equal operands, ``reduce_max`` an equal share to each tied maximum."""
    x = np.array([[-1.0, 0.0, 1.0, 2.0]], np.float32)
    (g,) = _port_grads(("clip", {"X": [feed(x, None, True)]},
                        {"min": 0.0, "max": 1.0}, ("Out",)),
                       {"Out": np.ones_like(x)})
    np.testing.assert_array_equal(g, [[0.0, 0.5, 0.5, 0.0]])
    y = np.array([[-1.0, 0.0, 3.0, 2.0]], np.float32)
    gx, gy = _port_grads(("maximum", {"X": [feed(x, None, True)],
                                      "Y": [feed(y, None, True)]}, {},
                          ("Out",)), {"Out": np.ones_like(x)})
    np.testing.assert_array_equal(gx, [[0.5, 0.5, 0.0, 0.5]])
    np.testing.assert_array_equal(gy, [[0.5, 0.5, 1.0, 0.5]])
    t = np.array([[3.0, 1.0, 3.0], [2.0, 2.0, 2.0]], np.float32)
    (g,) = _port_grads(("reduce_max", {"X": [feed(t, None, True)]},
                        {"dim": [1]}, ("Out",)), {"Out": np.ones(2,
                                                                 np.float32)})
    np.testing.assert_allclose(g, [[0.5, 0, 0.5], [1 / 3, 1 / 3, 1 / 3]],
                               rtol=1e-6)


def test_argsort_is_stable():
    """Equal values keep their input order."""
    x = np.array([[2.0, 1.0, 2.0, 1.0, 0.0, 1.0]], np.float32)
    case = ("argsort", {"X": [feed(x)]}, {"axis": -1}, ("Out", "Indices"))
    main, feeds, outs, _ = _build(tf, case)
    _, idx = _run(tf, main, feeds, outs)
    np.testing.assert_array_equal(np.asarray(idx), [[4, 1, 3, 5, 0, 2]])


BUILDERS = {
    "clip": lambda pkg: pkg.layers.clip(_data(pkg), -0.5, 0.5),
    "clip_by_norm": lambda pkg: pkg.layers.clip_by_norm(_data(pkg), 2.0),
    "sqrt": lambda pkg: pkg.layers.sqrt(_data(pkg)),
    "l2_normalize": lambda pkg: pkg.layers.l2_normalize(_data(pkg), -1),
    "dice_loss": lambda pkg: pkg.layers.dice_loss(
        _data(pkg, shape=(5,)), _data(pkg, "y", (1,), "int64")),
    "argmax": lambda pkg: pkg.layers.argmax(_data(pkg), axis=1),
    "argmin": lambda pkg: pkg.layers.argmin(_data(pkg)),
    "argsort": lambda pkg: pkg.layers.argsort(_data(pkg), axis=0),
    "cumsum": lambda pkg: pkg.layers.cumsum(_data(pkg), axis=1,
                                            exclusive=True, reverse=True),
    "reduce_max": lambda pkg: pkg.layers.reduce_max(_data(pkg), dim=1),
    "reduce_min": lambda pkg: pkg.layers.reduce_min(_data(pkg), dim=[0, 2],
                                                    keep_dim=True),
    "reduce_prod": lambda pkg: pkg.layers.reduce_prod(_data(pkg)),
    "has_inf": lambda pkg: pkg.layers.has_inf(_data(pkg)),
    "has_nan": lambda pkg: pkg.layers.has_nan(_data(pkg)),
    "isfinite": lambda pkg: pkg.layers.isfinite(_data(pkg)),
    "ones": lambda pkg: pkg.layers.ones([2, 3], "float32"),
    "create_tensor": lambda pkg: pkg.layers.create_tensor("float32",
                                                          persistable=True),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_emits_reference_program(name):
    """The same builder call gives the same ops, slots, attrs, variable
    names, shapes and dtypes in both packages."""
    assert _builder_program(tf, BUILDERS[name]) == \
        _builder_program(rf, BUILDERS[name])
