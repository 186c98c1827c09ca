"""The port's remaining random and fill ops (``paddle_tpu_torch/ops/
random_ops.py``) and the two initializers against the JAX package's, on
the CPU.  The packages draw different numbers from one seed (torch's
generator against JAX's threefry key), so draws are held to their
distribution, not to the reference's values:

 - each of the 7 op types gives the reference's shape and dtype; the
   deterministic ones (``fill_zeros_like``, ``shuffle_channel``,
   ``range``) its values too, and ``shuffle_channel`` its grad;
 - the uniform, normal and truncated normal draws pass a
   Kolmogorov-Smirnov test at p > 1e-3 against their distributions, the
   truncated draw lies within its bounds exactly, and ``sampling_id``'s
   counts over rows that do not sum to 1 pass a chi-square test at
   p > 1e-3; a nonzero ``seed`` gives the same draw twice;
 - ``range`` needs its ``_static_len`` attr in both packages;
 - ``Bilinear`` gives the reference's filter values, and
   ``TruncatedNormal`` a draw within two standard deviations.
"""

import numpy as np
import pytest
from scipy import stats

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import (_build, _run, compare_with_reference,
                                     const, feed)

P_MIN = 1e-3


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _run_op(pkg, op_type, inputs, attrs, outs=("Out",), runs=1):
    """``op_type`` on fed inputs ``{slot: array}`` in a fresh Program:
    the fetched outputs of each of ``runs`` runs."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        names = {}
        for slot, arr in inputs.items():
            block.create_var(name=slot.lower(), shape=arr.shape,
                             dtype=str(arr.dtype), is_data=True)
            names[slot] = [slot.lower()]
        for slot in outs:
            block.create_var(name=f"out_{slot}", dtype="float32")
        block.append_op(type=op_type, inputs=names,
                        outputs={s: [f"out_{s}"] for s in outs},
                        attrs=dict(attrs))
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    feeds = {slot.lower(): arr for slot, arr in inputs.items()}
    return [exe.run(main, feed=feeds, fetch_list=[f"out_{s}" for s in outs],
                    scope=scope) for _ in range(runs)]


X = np.random.RandomState(0).standard_normal((64, 6)).astype(np.float32)
PROBS = np.array([[0.5, 0.1, 2.0, 0.0, 0.4, 1.0]], np.float32)

DRAWS = {
    "uniform_random_batch_size_like": (
        {"Input": X}, {"shape": [-1, 500], "min": -2.0, "max": 3.0},
        stats.uniform(-2.0, 5.0).cdf),
    "uniform_random_batch_size_like_dim1": (
        {"Input": X}, {"shape": [40, -1], "input_dim_idx": 1,
                       "output_dim_idx": 1}, stats.uniform(-1.0, 2.0).cdf),
    "gaussian_random_batch_size_like": (
        {"Input": X}, {"shape": [-1, 300], "mean": 1.5, "std": 0.5},
        stats.norm(1.5, 0.5).cdf),
    "truncated_gaussian_random": (
        {}, {"shape": [400, 96], "mean": 0.5, "std": 0.02},
        stats.truncnorm(-2.0, 2.0, 0.5, 0.02).cdf),
}


def _op_of(name):
    return name.replace("_dim1", "")


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_shape_dtype_and_distribution(name):
    inputs, attrs, cdf = DRAWS[name]
    (ref,), = _run_op(rf, _op_of(name), inputs, attrs)
    (port,), = _run_op(tf, _op_of(name), inputs, attrs)
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.float32
    assert stats.kstest(port.reshape(-1), cdf).pvalue > P_MIN
    if name == "truncated_gaussian_random":
        mean, std = attrs["mean"], attrs["std"]
        assert port.min() >= np.float32(mean - 2 * std)
        assert port.max() <= np.float32(mean + 2 * std)


def test_sampling_id_counts_follow_the_row():
    x = np.repeat(PROBS, 20000, 0)
    (ref,), = _run_op(rf, "sampling_id", {"X": x[:8]}, {})
    (port,), = _run_op(tf, "sampling_id", {"X": x}, {})
    assert port.dtype == ref.dtype == np.int64
    assert port.shape == (x.shape[0],) and ref.shape == (8,)
    counts = np.bincount(port, minlength=PROBS.shape[1])
    assert counts[3] == 0  # probability 0 is never drawn
    keep = PROBS[0] > 0
    expected = PROBS[0][keep] / PROBS[0].sum() * x.shape[0]
    assert stats.chisquare(counts[keep], expected).pvalue > P_MIN


@pytest.mark.parametrize("name", ["uniform_random_batch_size_like",
                                  "gaussian_random_batch_size_like",
                                  "truncated_gaussian_random"])
def test_nonzero_seed_repeats_its_draw(name):
    inputs, attrs, _ = DRAWS[name]
    attrs = dict(attrs, seed=11)
    first, second = _run_op(tf, _op_of(name), inputs, attrs, runs=2)
    np.testing.assert_array_equal(first[0], second[0])
    (other,), = _run_op(tf, _op_of(name), inputs, attrs)
    np.testing.assert_array_equal(other, first[0])
    unseeded = _run_op(tf, _op_of(name), inputs, DRAWS[name][1], runs=2)
    assert not np.array_equal(unseeded[0][0], unseeded[1][0])


def test_sampling_id_seed_repeats_its_draw():
    x = np.repeat(PROBS, 500, 0)
    first, second = _run_op(tf, "sampling_id", {"X": x}, {"seed": 3}, runs=2)
    np.testing.assert_array_equal(first[0], second[0])


DETERMINISTIC = {
    "fill_zeros_like": ("fill_zeros_like", {"X": [feed(X)]}, {}, ("Out",)),
    "shuffle_channel": ("shuffle_channel",
                        {"X": [feed(np.random.RandomState(1).standard_normal(
                            (2, 12, 3, 4)).astype(np.float32), None, True)]},
                        {"group": 3}, ("Out",)),
    "range_float": ("range", {"Start": [const(np.array([1.5], np.float32))],
                              "End": [const(np.array([9.0], np.float32))],
                              "Step": [const(np.array([0.75], np.float32))]},
                    {"_static_len": 10}, ("Out",)),
    "range_int": ("range", {"Start": [const(np.array([-4], np.int64))],
                            "End": [const(np.array([11], np.int64))],
                            "Step": [const(np.array([3], np.int64))]},
                  {"_static_len": 5}, ("Out",)),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_op_matches_reference(name):
    compare_with_reference(DETERMINISTIC[name])


def test_range_needs_its_static_length():
    case = DETERMINISTIC["range_int"]
    bare = (case[0], case[1], {}, case[3])
    for pkg in (rf, tf):
        main, feeds, outs, _ = _build(pkg, bare)
        with pytest.raises(Exception, match="static"):
            _run(pkg, main, feeds, outs)


def _init_filter(pkg, initializer, shape=(4, 1, 4, 4)):
    """The startup value of a conv2d_transpose filter under
    ``initializer``, and the startup's op types."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[shape[0], 5, 5],
                            dtype="float32")
        pkg.layers.conv2d_transpose(
            x, shape[0] * shape[1], filter_size=list(shape[2:]), stride=2,
            padding=1, groups=shape[0], bias_attr=False,
            param_attr=pkg.ParamAttr(name="up.w", initializer=initializer))
    scope = pkg.Scope()
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    return (np.array(scope.get("up.w")),
            [op.type for op in startup.global_block().ops])


@pytest.mark.parametrize("shape", [(4, 1, 4, 4), (2, 3, 3, 5)])
def test_bilinear_initializer_matches_reference(shape):
    ref, ref_ops = _init_filter(rf, rf.initializer.Bilinear(), shape)
    port, port_ops = _init_filter(tf, tf.initializer.Bilinear(), shape)
    assert port_ops == ref_ops == ["assign_value"]
    np.testing.assert_array_equal(port, ref)
    assert tf.initializer.BilinearInitializer is tf.initializer.Bilinear


def test_truncated_normal_initializer_stays_in_bounds():
    init = tf.initializer.TruncatedNormal(loc=0.1, scale=0.02)
    port, port_ops = _init_filter(tf, init, (64, 8, 4, 4))
    _, ref_ops = _init_filter(rf, rf.initializer.TruncatedNormal(0.1, 0.02),
                              (64, 8, 4, 4))
    assert port_ops == ref_ops == ["truncated_gaussian_random"]
    assert port.min() >= np.float32(0.06) and port.max() <= np.float32(0.14)
    cdf = stats.truncnorm(-2.0, 2.0, 0.1, 0.02).cdf
    assert stats.kstest(port.reshape(-1), cdf).pvalue > P_MIN
