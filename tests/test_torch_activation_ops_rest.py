"""The port's remaining activation ops (``paddle_tpu_torch/ops/
activation_ops.py``) against the JAX package's, on the CPU, through the
one-op harness of ``test_torch_sequence_ops.py``: every output within
fp32 rtol 1e-5 / atol 1e-6, and the input grads (from
``append_backward`` of ``sum(out * c)``) within the same tolerance.

The inputs hold the points where torch's own functions part from JAX's:
exact bounds of ``relu6`` / ``brelu`` / ``hard_sigmoid`` / ``soft_relu``
(``jnp.clip`` gives half the grad at a bound), 0 for ``abs`` (grad 1 in
JAX) and for ``leaky_relu`` / ``elu`` / ``prelu`` (the ``x >= 0``
branch), the shrinks' thresholds, halves for ``round`` (to even), large
magnitudes for ``softplus`` / ``logsigmoid`` (``logaddexp``), and 1.0
for ``gelu`` (the tanh form).  The builders of ``fluid.layers`` emit the
reference's ops, attrs, names, shapes and dtypes.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import _build, _run, compare_with_reference, feed


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _x(seed, *special, shape=(4, 6), scale=2.0):
    """A seeded normal input with ``special`` values written over its
    first elements."""
    x = (np.random.RandomState(seed).standard_normal(shape) * scale).astype(
        np.float32)
    x.reshape(-1)[:len(special)] = special
    return x


def _positive(seed, shape=(4, 6)):
    return np.random.RandomState(seed).uniform(0.2, 3.0, shape).astype(
        np.float32)


# op type -> (input, attrs); every one differentiable
UNARY = {
    "abs": (_x(1, 0.0, -0.0, 1.5, -1.5), {}),
    "sqrt": (_positive(2), {}),
    "rsqrt": (_positive(3), {}),
    "reciprocal": (_x(4, 0.5, -0.25, 3.0), {}),
    "round": (_x(5, 0.5, 1.5, 2.5, -0.5, -1.5, 0.49), {}),
    "sin": (_x(6), {}),
    "softplus": (_x(7, 0.0, 30.0, -30.0, 21.0, -90.0), {}),
    "softsign": (_x(8, 0.0), {}),
    "softshrink": (_x(9, 0.5, -0.5, 0.0, 0.51), {}),
    "gelu": (_x(10, 1.0, 0.0, -1.0, 4.0), {}),
    "logsigmoid": (_x(11, 0.0, 30.0, -30.0, -90.0), {}),
    "tanh_shrink": (_x(12, 0.0), {}),
    "log_softmax": (_x(13, 50.0, -50.0), {}),
    "log_softmax_axis0": (_x(14), {"axis": 0}),
    "relu6": (_x(15, 0.0, 6.0, 6.5, -0.5, scale=4.0), {"threshold": 6.0}),
    "leaky_relu": (_x(16, 0.0, -0.0), {"alpha": 0.1}),
    "elu": (_x(17, 0.0), {"alpha": 0.7}),
    "pow": (_x(18, 0.0, 1.0), {"factor": 2.0}),
    "pow_fractional": (_positive(19), {"factor": 2.5}),
    "stanh": (_x(20, 0.0), {"scale_a": 0.67, "scale_b": 1.7159}),
    # slope 0.25 puts -2 and 2 exactly on the bounds; at slope 0.2 the
    # reference's jitted slope * x + offset is one fused multiply-add,
    # whose unrounded product moves x = -2.5 off the bound 0 (grad 0
    # there, 0.5 * slope in the port, which rounds the product first)
    "hard_sigmoid": (_x(21, 2.0, -2.0, 0.0), {"slope": 0.25, "offset": 0.5}),
    "hard_shrink": (_x(22, 0.5, -0.5, 0.0), {"threshold": 0.5}),
    "thresholded_relu": (_x(23, 1.0, 0.0), {"threshold": 1.0}),
    "soft_relu": (_x(24, 2.0, -2.0, 0.0), {"threshold": 2.0}),
    "brelu": (_x(25, 0.0, 4.0, -1.0, 5.0), {"t_min": 0.0, "t_max": 4.0}),
    "swish": (_x(26, 0.0), {"beta": 1.5}),
}


def _cases():
    cases = {}
    for name, (x, attrs) in UNARY.items():
        op = name.split("_axis")[0].replace("_fractional", "")
        cases[name] = (op, {"X": [feed(x, None, True)]}, attrs, ("Out",))
    x = _x(27, 0.0, -0.0, shape=(2, 3, 4))
    rng = np.random.RandomState(28)
    for mode, n in (("all", 1), ("channel", 3), ("element", 12)):
        alpha = rng.uniform(0.05, 0.5, (n,)).astype(np.float32)
        cases[f"prelu_{mode}"] = (
            "prelu", {"X": [feed(x, None, True)],
                      "Alpha": [feed(alpha, None, True)]},
            {"mode": mode}, ("Out",))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_activation_op_matches_reference(name):
    compare_with_reference(CASES[name])


def _port_grad(op, x, attrs):
    """The port's grad of ``sum(op(x))`` at ``x``."""
    case = (op, {"X": [feed(x, None, True)]}, attrs, ("Out",))
    main, feeds, _, grads = _build(tf, case, {"Out": np.ones_like(x)})
    return np.asarray(_run(tf, main, feeds, grads)[0])


@pytest.mark.parametrize("op,x,attrs,want", [
    ("relu6", [0.0, 6.0, 3.0, 7.0], {"threshold": 6.0}, [0.5, 0.5, 1, 0]),
    ("brelu", [1.0, 4.0, 2.0], {"t_min": 1.0, "t_max": 4.0}, [0.5, 0.5, 1]),
    ("abs", [0.0, -2.0, 2.0], {}, [1.0, -1.0, 1.0]),
    ("leaky_relu", [0.0, -1.0], {"alpha": 0.1}, [1.0, 0.1]),
    ("elu", [0.0], {"alpha": 0.7}, [1.0]),
])
def test_tie_grads_follow_jax(op, x, attrs, want):
    """At a clip bound the grad is 0.5 (``jnp.clip``; ``torch.clamp``
    gives 1), ``abs`` has grad 1 at 0 (torch's is 0), and the selects take
    the ``x >= 0`` branch at 0."""
    x = np.array([x], np.float32)
    np.testing.assert_allclose(_port_grad(op, x, attrs)[0], want, rtol=1e-6)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu``'s default: 0.841192 at 1.0 (the exact erf form
    gives 0.841345)."""
    case = ("gelu", {"X": [feed(np.ones((1, 1), np.float32))]}, {}, ("Out",))
    main, feeds, outs, _ = _build(tf, case)
    got = float(np.asarray(_run(tf, main, feeds, outs)[0]).reshape(-1)[0])
    assert abs(got - 0.841192) < 1e-6


def test_prelu_refuses_an_unknown_mode():
    case = ("prelu", {"X": [feed(np.ones((2, 3), np.float32))],
                      "Alpha": [feed(np.ones((1,), np.float32))]},
            {"mode": "row"}, ("Out",))
    main, feeds, outs, _ = _build(tf, case)
    with pytest.raises(ValueError, match="mode"):
        _run(tf, main, feeds, outs)


def _builder_program(pkg, build):
    """The ops (type, slots, attrs) and the variables (name, shape, dtype)
    of what ``build(pkg)`` emits."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        build(pkg)
    block = main.global_block()
    ops = [(op.type, {s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if not k.startswith("op_")})
           for op in block.ops]
    var_list = [(v.name, tuple(v.shape) if v.shape is not None else None,
                 str(v.dtype)) for v in block.vars.values()]
    starts = [op.type for op in startup.global_block().ops]
    return ops, sorted(var_list), starts


def _data(pkg, name="x", shape=(3, 4), dtype="float32"):
    return pkg.layers.data(name=name, shape=list(shape), dtype=dtype)


ATTR_DEFAULTS = {
    "relu6": {}, "leaky_relu": {"alpha": 0.1}, "elu": {}, "pow":
    {"factor": 3.0}, "stanh": {"scale_b": 2.0}, "hard_sigmoid":
    {"slope": 0.3}, "hard_shrink": {}, "thresholded_relu":
    {"threshold": 0.5}, "brelu": {"t_max": 10.0}, "swish": {"beta": 2.0},
}


def _builders():
    builders = {}
    for op in ("abs", "sqrt", "rsqrt", "reciprocal", "round", "sin",
               "softplus", "softsign", "softshrink", "gelu", "logsigmoid",
               "tanh_shrink", "log_softmax", "soft_relu"):
        builders[op] = lambda pkg, _op=op: getattr(pkg.layers, _op)(
            _data(pkg))
    for op, kw in ATTR_DEFAULTS.items():
        builders[op] = lambda pkg, _op=op, _kw=kw: getattr(pkg.layers, _op)(
            _data(pkg), **_kw)
    for mode in ("all", "channel", "element"):
        builders[f"prelu_{mode}"] = lambda pkg, _m=mode: pkg.layers.prelu(
            _data(pkg, shape=(3, 4, 5)), _m)
    builders["uniform_random"] = lambda pkg: pkg.layers.uniform_random(
        [3, 5], min=-0.5, max=0.5, seed=4)
    return builders


BUILDERS = _builders()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_emits_reference_program(name):
    """The same builder call gives the same ops, slots, attrs, variable
    names, shapes and dtypes (and startup ops) in both packages."""
    assert _builder_program(tf, BUILDERS[name]) == \
        _builder_program(rf, BUILDERS[name])
