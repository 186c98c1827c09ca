"""The ops the BERT, DeepFM and SE-ResNeXt slice adds to the port, each
built alone in both packages, against the JAX package on the CPU:
``sigmoid``, ``tanh``, ``square``, ``sigmoid_cross_entropy_with_logits``
(with and without ``ignore_index``), ``gather`` (repeated indices),
``slice`` (negative, clamped and empty bounds) and ``split``.  The same
numpy-seeded inputs; ``loss = reduce_sum(op(x) · w)`` with a fixed random
``w``, so no grad vanishes by symmetry; the op's output and ``d loss /
d x`` at rtol 1e-5 / atol 1e-5 (float32 on both sides).

Under bf16 AMP with kept activations, each op's impl and generic grad
alone on a bf16 activation (eager in both packages, so the reference
rounds where its source says): the output and grad dtypes equal the
reference's (``sigmoid_cross_entropy_with_logits`` of a bf16 ``x`` and an
fp32 label is fp32; ``gather``, ``slice`` and the activations keep bf16),
and the values lie within 1 ulp of their dtype at the tensor's largest
magnitude (fp32 ones within 1e-5 of it): both packages compute the same
expression and round once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.ops import registry as ref_reg
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import registry as port_reg

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _labels(shape, ignore):
    """0 / 1 labels, and ``ignore`` at a few places when it is >= 0."""
    lab = (np.random.RandomState(3).uniform(size=shape) < 0.5).astype(
        np.float32)
    if ignore >= 0:
        lab.reshape(-1)[::5] = ignore
    return lab


def _sigmoid_ce(ignore):
    def build(L, v):
        return L.sigmoid_cross_entropy_with_logits(
            v["x"], v["label"], ignore_index=ignore)
    return build


def _slice(axes, starts, ends):
    """``reduce_sum(slice(x · w_x))``: the loss's weight applied before the
    slice (a start below ``-dim`` is clamped to 0 by the op, not by the
    layer's static shape, in both packages)."""
    def build(L, v):
        wx = L.assign(_rand(*v["x"].shape, seed=5))
        return L.reduce_sum(L.slice(L.elementwise_mul(v["x"], wx),
                                    axes=axes, starts=starts, ends=ends))
    return build


X = _rand(6, 5, 4)
# case: (inputs, differentiable inputs, build)
CASES = {
    "sigmoid": ({"x": X}, ["x"], lambda L, v: L.sigmoid(v["x"])),
    "tanh": ({"x": X}, ["x"], lambda L, v: L.tanh(v["x"])),
    "square": ({"x": X}, ["x"], lambda L, v: L.square(v["x"])),
    "sigmoid_ce": ({"x": _rand(8, 3) * 4, "label": _labels((8, 3), -100)},
                   ["x"], _sigmoid_ce(-100)),
    "sigmoid_ce_ignore": (
        {"x": _rand(8, 3) * 4, "label": _labels((8, 3), 2)}, ["x"],
        _sigmoid_ce(2)),
    "gather": ({"x": _rand(7, 5), "index": np.array([3, 0, 3, 6, 1, 3],
                                                    np.int64)},
               ["x"], lambda L, v: L.gather(v["x"], v["index"])),
    "slice_cls": ({"x": X}, ["x"], _slice([1], [0], [1])),
    "slice_negative": ({"x": X}, ["x"], _slice([0, 2], [-4, 1], [-1, 3])),
    "slice_clamped": ({"x": X}, ["x"], _slice([1, 2], [-9, 2], [99, 10])),
    "slice_empty": ({"x": X}, ["x"], _slice([0], [4], [2])),
    "split": ({"x": X}, ["x"],
              lambda L, v: L.elementwise_mul(*L.split(v["x"], [2, 2], 2))),
    "split_num": ({"x": X}, ["x"],
                  lambda L, v: L.elementwise_mul(*L.split(v["x"], 2, 0))),
}


def _run(pkg, inputs, diff, build):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        v = {name: L.data(name, shape=list(arr.shape), dtype=str(arr.dtype),
                          append_batch_size=False,
                          stop_gradient=name not in diff)
             for name, arr in inputs.items()}
        out = build(L, v)
        w = L.assign(_rand(*out.shape, seed=9))
        loss = L.reduce_sum(L.elementwise_mul(out, w))
        pkg.backward.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    fetch = [out.name, loss.name] + [n + "@GRAD" for n in diff]
    got = exe.run(prog, feed=dict(inputs), fetch_list=fetch, scope=scope)
    types = [op.type for op in prog.global_block().ops]
    return [np.asarray(g) for g in got], types, tuple(out.shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    inputs, diff, build = CASES[case]
    ref, ref_types, ref_shape = _run(rf, inputs, diff, build)
    port, port_types, port_shape = _run(tf, inputs, diff, build)
    assert port_types == ref_types
    assert port_shape == ref_shape
    for name, r, p in zip(["out", "loss"] + diff, ref, port):
        assert p.shape == r.shape and p.dtype == r.dtype, name
        np.testing.assert_allclose(p, r, err_msg=name, **TOL)
    if case == "sigmoid_ce_ignore":
        lab = inputs["label"]
        assert not port[0][lab == 2].any() and not port[2][lab == 2].any()
    if case == "slice_empty":
        assert not port[0].any() and not port[2].any()


# op case under bf16 keep -> (op type, {slot: (array, is a bf16
# activation)}, attrs, differentiable input slot)
AMP_CASES = {
    "sigmoid": ("sigmoid", {"X": (X, True)}, {}, "X"),
    "tanh": ("tanh", {"X": (X, True)}, {}, "X"),
    "square": ("square", {"X": (X, True)}, {}, "X"),
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits",
                   {"X": (_rand(8, 3) * 4, True),
                    "Label": (_labels((8, 3), 2), False)},
                   {"ignore_index": 2}, "X"),
    "gather": ("gather", {"X": (_rand(7, 5), True),
                          "Index": (np.array([3, 0, 3, 6], np.int64), False)},
               {}, "X"),
    "slice": ("slice", {"Input": (X, True)},
              {"axes": [0, 2], "starts": [-4, 1], "ends": [99, 3]}, "Input"),
}


@pytest.fixture
def bf16_keep():
    saved = dict(ref_amp._state), dict(port_amp._state)
    for amp in (ref_amp, port_amp):
        amp.enable("bfloat16", keep_activations=True)
    yield
    for amp, state in zip((ref_amp, port_amp), saved):
        amp._state.update(state)
        amp.disable()


def _assert_dtype_close(what, ref, port):
    """The same dtype; within 1 ulp of a bf16 value at the largest
    magnitude, 1e-5 of it for fp32."""
    ref = jnp.asarray(ref)
    assert str(port.dtype).replace("torch.", "") == str(ref.dtype), what
    r = np.asarray(ref.astype(jnp.float32), np.float64)
    p = port.detach().double().numpy()
    mag = float(np.abs(r).max())
    tol = 1e-5 * mag if ref.dtype == jnp.float32 else \
        2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - 7)
    assert float(np.abs(p - r).max()) <= tol, what


@pytest.mark.parametrize("case", sorted(AMP_CASES))
def test_op_matches_reference_under_bf16_keep(case, bf16_keep):
    op, spec, attrs, diff = AMP_CASES[case]
    ref_in = {s: [jnp.asarray(a).astype(jnp.bfloat16) if act
                  else jnp.asarray(a)] for s, (a, act) in spec.items()}
    port_in = {s: [torch.from_numpy(a).to(torch.bfloat16) if act
                   else torch.from_numpy(a)] for s, (a, act) in spec.items()}
    ref_out = ref_reg.get_op_def(op).fn(
        ref_reg.ExecContext(op, ref_in, {"Out": ["Out"]}, attrs))["Out"]
    port_out = port_reg.get_op_def(op).fn(port_reg.ExecContext(
        op, port_in, {"Out": ["Out"]}, attrs, torch.device("cpu")))["Out"]
    _assert_dtype_close(f"{case} out", ref_out, port_out)
    if case == "sigmoid_ce":
        assert port_out.dtype == torch.float32
    g = _rand(*port_out.shape, seed=7)
    dt = jnp.asarray(ref_out).dtype
    ref_in["Out@GRAD"] = [jnp.asarray(g).astype(dt)]
    port_in["Out@GRAD"] = [torch.from_numpy(g).to(port_out.dtype)]
    want = {diff + "@GRAD": [diff + "@GRAD"]}
    ref_g = ref_reg.run_grad_generic(
        ref_reg.get_op_def(op), ref_reg.ExecContext(op, ref_in, want, attrs))
    port_g = port_reg.run_grad_generic(
        port_reg.get_op_def(op),
        port_reg.ExecContext(op, port_in, want, attrs, torch.device("cpu")))
    _assert_dtype_close(f"{case} grad", ref_g[diff + "@GRAD"][0],
                        port_g[diff + "@GRAD"][0])
