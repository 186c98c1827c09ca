"""The port's quantization ops (``paddle_tpu_torch/ops/quant_ops.py``)
against the JAX package's, on the CPU, through the one-op harness of
``test_torch_sequence_ops.py``:

 - every output bitwise the reference's (a rounding or a scale is exact
   or wrong; a scale fed at run time, as the transpiler's and a QAT
   program's are: the reference's compiled program then multiplies by
   the float32 reciprocal of a constant divisor, while a constant scale
   it folds with an exact division), and the straight-through grads (``fake_quantize_*``: the
   incoming grad; ``fake_dequantize_max_abs``: times the scale) at fp32
   rtol 1e-5 / atol 1e-6;
 - ``dequantize_weight`` along axis 0 and 1, int8 at ±127;
 - ``fake_quantize_abs_max`` on ties: inputs whose ``x / scale · 127``
   is exactly ``k + 0.5`` in float32 round half to even in both packages
   (and as numpy's ``round``);
 - ``fake_quantize_range_abs_max`` training (its window of scales) and
   ``is_test`` (``InScale``), with ``Iter`` past the window's size.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import (_build, _run, compare_with_reference,
                                     const, feed)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _ties():
    """Half-integers k + 0.5 whose ``x / 127 · 127`` stays exact in
    float32, and 127 itself (the scale)."""
    half = np.arange(-126.5, 127.0, 1.0).astype(np.float32)
    exact = half[(half / np.float32(127) * np.float32(127)) == half]
    return np.concatenate([exact, [np.float32(127)]]).reshape(1, -1)


def _int8(seed, *shape):
    q = np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)
    q.flat[0], q.flat[1] = 127, -127
    return q


def _cases():
    scale = np.abs(_f32(1, 6)) + 0.1
    return {
        "dequantize_weight_axis0": (
            "dequantize_weight", {"X": [feed(_int8(2, 6, 5))],
                                  "Scale": [feed(scale)]},
            {"quant_axis": 0}, ("Out",)),
        "dequantize_weight_axis1": (
            "dequantize_weight", {"X": [feed(_int8(3, 4, 6))],
                                  "Scale": [feed(scale)]},
            {"quant_axis": 1}, ("Out",)),
        "fake_quantize_abs_max": (
            "fake_quantize_abs_max", {"X": [feed(_f32(4, 5, 7), None, True)]},
            {"bit_length": 8}, ("Out", "OutScale")),
        "fake_quantize_abs_max_ties": (
            "fake_quantize_abs_max", {"X": [feed(_ties(), None, True)]},
            {"bit_length": 8}, ("Out", "OutScale")),
        "fake_quantize_abs_max_4bit": (
            "fake_quantize_abs_max", {"X": [feed(_f32(5, 3, 8), None, True)]},
            {"bit_length": 4}, ("Out", "OutScale")),
        "fake_quantize_range_abs_max": (
            "fake_quantize_range_abs_max",
            {"X": [feed(_f32(6, 4, 5), None, True)],
             "InScale": [const(np.array([0.7], np.float32))],
             "Iter": [const(np.array([6], np.int64))]},
            {"window_size": 4, "bit_length": 8, "is_test": False},
            ("Out", "OutScale", "OutScales", "IterOut")),
        "fake_quantize_range_abs_max_test": (
            "fake_quantize_range_abs_max",
            {"X": [feed(_f32(7, 4, 5), None, True)],
             "InScale": [const(np.array([0.7], np.float32))],
             "Iter": [const(np.array([6], np.int64))]},
            {"window_size": 4, "bit_length": 8, "is_test": True},
            ("Out", "OutScale")),
        "fake_dequantize_max_abs": (
            "fake_dequantize_max_abs",
            {"X": [feed(np.round(_f32(8, 4, 6) * 40), None, True)],
             "Scale": [const(np.array([2.5], np.float32))]},
            {"max_range": 127.0}, ("Out",)),
        "fake_dequantize_max_abs_scales": (
            "fake_dequantize_max_abs",
            {"X": [feed(np.round(_f32(9, 8, 16) * 40), None, True)],
             "Scale": [feed(np.abs(_f32(10, 1)) + 0.1)]},
            {"max_range": 7.0}, ("Out",)),
    }


CASES = _cases()


def _outputs(pkg, case):
    main, feeds, outs, _ = _build(pkg, case)
    return [np.asarray(v) for v in _run(pkg, main, feeds, outs)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_quant_op_matches_reference(name):
    case = CASES[name]
    ref, port = _outputs(rf, case), _outputs(tf, case)
    for slot, r, p in zip(case[3], ref, port):
        assert p.dtype == r.dtype and p.shape == r.shape, (slot, p, r)
        np.testing.assert_array_equal(p, r, err_msg=slot)
    compare_with_reference(case)  # and the grads


def test_ties_round_half_to_even():
    x = _ties()
    assert x.size > 100  # the ties the test rests on exist
    (out, scale) = _outputs(tf, CASES["fake_quantize_abs_max_ties"])
    assert scale[0] == 127.0
    np.testing.assert_array_equal(out, np.round(x))
    halves = x[np.abs(x) < 127]
    assert (np.abs(np.round(halves) % 2) == 0).all()  # to even, not away
