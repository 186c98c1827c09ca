"""The port's recurrent ops (``paddle_tpu_torch/ops/rnn_ops.py``) against
the JAX package's, on the CPU, through the same one-op Programs as
``tests/test_torch_sequence_ops.py`` (``compare_with_reference``): every
output and its LoD, then the grads of every float input (the generic grad
in both packages), fp32 rtol 1e-5 / atol 1e-6.  Numpy-seeded inputs,
ragged lengths with a sequence of length 1 (and an empty one); peepholes
on and off, reverse, ``H0`` / ``C0``, other activations, the recurrent
projection, ``origin_mode``; the unit cells on a batch."""

import numpy as np
import pytest

from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from tests.test_torch_sequence_ops import compare_with_reference, feed

D, P = 4, 3


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _lstm(lens, peep=True, reverse=False, init=False, project=False,
          acts=None, seed=0):
    rng = np.random.RandomState(seed)
    total, n = sum(lens), len(lens)
    inputs = {"Input": [feed(_f32(rng, total, 4 * D), [lens], True)],
              "Weight": [feed(_f32(rng, P if project else D, 4 * D), None,
                              True)],
              "Bias": [feed(_f32(rng, 1, (7 if peep else 4) * D), None,
                            True)]}
    if project:
        inputs["ProjWeight"] = [feed(_f32(rng, D, P), None, True)]
    if init:
        inputs["H0"] = [feed(_f32(rng, n, P if project else D), None, True)]
        inputs["C0"] = [feed(_f32(rng, n, D), None, True)]
    attrs = {"use_peepholes": peep, "is_reverse": reverse,
             **(acts or {})}
    if project:
        attrs.setdefault("proj_activation", "tanh")
    outs = ("Projection" if project else "Hidden", "Cell")
    return ("dynamic_lstmp" if project else "dynamic_lstm", inputs, attrs,
            outs)


def _gru(lens, reverse=False, init=False, origin=False, acts=None, seed=0):
    rng = np.random.RandomState(seed)
    total, n = sum(lens), len(lens)
    inputs = {"Input": [feed(_f32(rng, total, 3 * D), [lens], True)],
              "Weight": [feed(_f32(rng, D, 3 * D), None, True)],
              "Bias": [feed(_f32(rng, 1, 3 * D), None, True)]}
    if init:
        inputs["H0"] = [feed(_f32(rng, n, D), None, True)]
    attrs = {"is_reverse": reverse, "origin_mode": origin, **(acts or {})}
    return ("dynamic_gru", inputs, attrs, ("Hidden",))


def _gru_unit(acts=(2, 1), seed=0):
    rng = np.random.RandomState(seed)
    inputs = {"Input": [feed(_f32(rng, 5, 3 * D), None, True)],
              "HiddenPrev": [feed(_f32(rng, 5, D), None, True)],
              "Weight": [feed(_f32(rng, D, 3 * D), None, True)],
              "Bias": [feed(_f32(rng, 1, 3 * D), None, True)]}
    return ("gru_unit", inputs,
            {"activation": acts[0], "gate_activation": acts[1]},
            ("Gate", "ResetHiddenPrev", "Hidden"))


def _lstm_unit(forget_bias, seed=0):
    rng = np.random.RandomState(seed)
    inputs = {"X": [feed(_f32(rng, 5, 4 * D), None, True)],
              "C_prev": [feed(_f32(rng, 5, D), None, True)]}
    return ("lstm_unit", inputs, {"forget_bias": forget_bias}, ("C", "H"))


LENS = [3, 1, 5, 2]
CASES = {
    "lstm": _lstm(LENS),
    "lstm_no_peepholes": _lstm(LENS, peep=False),
    "lstm_reverse": _lstm(LENS, reverse=True),
    "lstm_h0_c0": _lstm(LENS, init=True),
    "lstm_reverse_h0_c0_no_peepholes": _lstm(LENS, peep=False,
                                             reverse=True, init=True),
    "lstm_fixed_lengths": _lstm([4, 4, 4]),
    "lstm_empty_sequence": _lstm([2, 0, 3]),
    "lstm_activations": _lstm(LENS, acts={
        "gate_activation": "sigmoid", "cell_activation": "relu",
        "candidate_activation": "identity"}),
    "lstmp": _lstm(LENS, project=True),
    "lstmp_reverse_h0_c0": _lstm(LENS, project=True, reverse=True,
                                 init=True, peep=False),
    "lstmp_identity_projection": _lstm(LENS, project=True, acts={
        "proj_activation": "identity"}),
    "gru": _gru(LENS),
    "gru_origin_mode": _gru(LENS, origin=True),
    "gru_reverse_h0": _gru(LENS, reverse=True, init=True),
    "gru_reverse_h0_origin_mode": _gru(LENS, reverse=True, init=True,
                                       origin=True),
    "gru_activations": _gru(LENS, acts={"gate_activation": "sigmoid",
                                        "activation": "relu"}),
    "gru_unit": _gru_unit(),
    "gru_unit_relu": _gru_unit((3, 1)),
    "lstm_unit": _lstm_unit(0.0),
    "lstm_unit_forget_bias": _lstm_unit(1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rnn_op_matches_reference(name):
    compare_with_reference(CASES[name])


def test_padding_maps_are_cached():
    """The packed <-> padded maps of one (offsets, reverse, device) are
    built once; the validity mask is skipped when every sequence is full
    length."""
    from paddle_tpu_torch.ops import rnn_ops

    a = rnn_ops._padding((0, 3, 4, 9), False, "cpu")
    assert rnn_ops._padding((0, 3, 4, 9), False, "cpu") is a
    assert rnn_ops._padding((0, 3, 4, 9), True, "cpu") is not a
    assert not a.full and a.t_max == 5 and a.n == 3
    assert rnn_ops._padding((0, 4, 8), False, "cpu").full
