"""The port's remaining loss ops (``paddle_tpu_torch/ops/loss_ops.py``:
huber, smooth-L1, log, hinge, rank, margin-rank, squared L2 norm and
distance, BPR, KL divergence) and ``im2sequence``
(``paddle_tpu_torch/ops/nn_ops.py``) against the JAX package's, on the
CPU, through the one-op harness of ``test_torch_sequence_ops.py``:
every output within fp32 rtol 1e-5 / atol 1e-6, and the grads of the
differentiable inputs (from ``append_backward`` of ``sum(out * c)``)
within the same tolerance.  ``im2sequence`` runs over kernels, strides
and paddings (symmetric and not).  The layer builders of these ops emit
the reference's ops, slots and attrs.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from test_torch_sequence_ops import compare_with_reference, feed


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cases():
    rng = np.random.RandomState(11)
    x, y = _f32(rng, 6, 3), _f32(rng, 6, 3)
    lab01 = (rng.rand(6, 1) > 0.5).astype(np.float32)
    cases = {
        "huber_loss": ("huber_loss", {"X": [feed(x * 2, None, True)],
                                      "Y": [feed(y)]},
                       {"delta": 0.7}, ("Out", "Residual")),
        "smooth_l1_loss": ("smooth_l1_loss", {"X": [feed(x, None, True)],
                                              "Y": [feed(y)]},
                           {"sigma": 1.5}, ("Out", "Diff")),
        "smooth_l1_loss_weighted": (
            "smooth_l1_loss",
            {"X": [feed(x, None, True)], "Y": [feed(y)],
             "InsideWeight": [feed(np.abs(_f32(rng, 6, 3)))],
             "OutsideWeight": [feed(np.abs(_f32(rng, 6, 3)))]},
            {"sigma": 0.8}, ("Out", "Diff")),
        "log_loss": ("log_loss",
                     {"Predicted": [feed(rng.uniform(0.05, 0.95, (6, 1))
                                         .astype(np.float32), None, True)],
                      "Labels": [feed(lab01)]},
                     {"epsilon": 1e-4}, ("Loss",)),
        "hinge_loss": ("hinge_loss", {"Logits": [feed(x[:, :1], None, True)],
                                      "Labels": [feed(lab01)]},
                       {}, ("Loss",)),
        "rank_loss": ("rank_loss", {"Label": [feed(lab01)],
                                    "Left": [feed(x[:, :1], None, True)],
                                    "Right": [feed(y[:, :1], None, True)]},
                      {}, ("Out",)),
        "margin_rank_loss": (
            "margin_rank_loss",
            {"Label": [feed(np.sign(_f32(rng, 6, 1)))],
             "X1": [feed(x[:, :1], None, True)],
             "X2": [feed(y[:, :1], None, True)]},
            {"margin": 0.3}, ("Out", "Activated")),
        "squared_l2_norm": ("squared_l2_norm", {"X": [feed(x, None, True)]},
                            {}, ("Out",)),
        "squared_l2_distance": (
            "squared_l2_distance",
            {"X": [feed(x, None, True)], "Y": [feed(y, None, True)]},
            {}, ("Out", "sub_result")),
        "squared_l2_distance_broadcast": (
            "squared_l2_distance",
            {"X": [feed(x, None, True)], "Y": [feed(y[:1], None, True)]},
            {}, ("Out", "sub_result")),
        "bpr_loss": ("bpr_loss",
                     {"X": [feed(_f32(rng, 6, 5), None, True)],
                      "Label": [feed(rng.randint(0, 5, (6, 1)))]},
                     {}, ("Y",)),
    }
    logp = np.log(np.abs(_f32(rng, 4, 5)) + 0.1).astype(np.float32)
    target = np.abs(_f32(rng, 4, 5))
    target[0, 1] = 0.0
    for red in ("mean", "sum", "batchmean", "none"):
        cases[f"kldiv_loss_{red}"] = (
            "kldiv_loss", {"X": [feed(logp, None, True)],
                           "Target": [feed(target)]},
            {"reduction": red}, ("Loss",))
    img = _f32(rng, 2, 3, 7, 9)
    for name, k, s, p in (("im2sequence_k2_s1", [2, 2], [1, 1], [0] * 4),
                          ("im2sequence_k3x2_s2x1", [3, 2], [2, 1], [0] * 4),
                          ("im2sequence_pad", [3, 3], [2, 2], [1, 1, 1, 1]),
                          ("im2sequence_pad_uneven", [2, 4], [1, 3],
                           [0, 2, 1, 1]),
                          ("im2sequence_full_height", [7, 3], [1, 3],
                           [0] * 4)):
        cases[name] = ("im2sequence", {"X": [feed(img, None, True)]},
                       {"kernels": k, "strides": s, "paddings": p}, ("Out",))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_op_matches_reference(name):
    compare_with_reference(CASES[name])


def _builder_ops(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = build(pkg)
    ops = [(op.type, {s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if not k.startswith("op_")})
           for op in main.global_block().ops]
    return ops, out.name


def _data(pkg, name, shape, dtype="float32", lod_level=0):
    return pkg.layers.data(name=name, shape=shape, dtype=dtype,
                           lod_level=lod_level)


BUILDERS = {
    "im2sequence": lambda pkg: pkg.layers.im2sequence(
        _data(pkg, "img", [1, 8, 12]), filter_size=[8, 3], stride=[1, 3],
        padding=[0, 1]),
    "smooth_l1": lambda pkg: pkg.layers.smooth_l1(
        _data(pkg, "x", [3]), _data(pkg, "y", [3]), sigma=2.0),
    "log_loss": lambda pkg: pkg.layers.log_loss(
        _data(pkg, "p", [1]), _data(pkg, "y", [1])),
    "huber_loss": lambda pkg: pkg.layers.huber_loss(
        _data(pkg, "x", [1]), _data(pkg, "y", [1]), 0.5),
    "rank_loss": lambda pkg: pkg.layers.rank_loss(
        _data(pkg, "l", [1]), _data(pkg, "a", [1]), _data(pkg, "b", [1])),
    "hsigmoid": lambda pkg: pkg.layers.hsigmoid(
        _data(pkg, "x", [4]), _data(pkg, "y", [1], "int64"), 6),
    "nce": lambda pkg: pkg.layers.nce(
        _data(pkg, "x", [4]), _data(pkg, "y", [1], "int64"), 20,
        num_neg_samples=4, seed=3),
    "warpctc": lambda pkg: pkg.layers.warpctc(
        _data(pkg, "x", [7], lod_level=1),
        _data(pkg, "y", [1], "int64", 1), blank=6, norm_by_times=True),
    "ctc_greedy_decoder": lambda pkg: pkg.layers.ctc_greedy_decoder(
        _data(pkg, "x", [7], lod_level=1), blank=6),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_emits_reference_ops(name):
    """The same builder call gives the same ops, slots, var names and
    attrs in both packages."""
    assert _builder_ops(tf, BUILDERS[name]) == \
        _builder_ops(rf, BUILDERS[name])


def test_im2sequence_output_has_no_static_shape_or_lod_in_either():
    """Both packages' ``im2sequence`` builder leaves its output's static
    shape unset (so ``fc`` cannot follow it until the caller sets one) and
    its op gives no LoD, where upstream Fluid gives one sequence per
    image: a shared fault (ROADMAP queue 3), held equal here."""
    img = np.random.RandomState(0).rand(2, 1, 4, 6).astype(np.float32)
    got = {}
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            out = pkg.layers.im2sequence(
                _data(pkg, "img", [1, 4, 6]), filter_size=[4, 2],
                stride=[1, 2])
        (v,) = pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"img": img}, fetch_list=[out], scope=pkg.Scope(),
            return_numpy=False)
        got[pkg] = (out.shape, np.asarray(v).shape,
                    tuple(v.lod()) if hasattr(v, "lod") else ())
    assert got[tf] == got[rf] == (None, (6, 8), ())
