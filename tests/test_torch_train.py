"""The training slice of the port against the JAX package, on the CPU:

 - ``transformer.build`` (``tiny_config()``, ``flash_attention=False``)
   gives the same startup and main Programs in both packages: op lists,
   attrs, var shapes and dtypes (exact: the IR is data);
 - every ``<type>_grad`` op of that program, built alone, gives the same
   input gradients in both packages (rtol 1e-5, atol 1e-6: float32 on both
   sides, the sums in another order); dropout, whose masks come from
   different generators, is held to ``dOut · Mask`` with each package's own
   mask;
 - with the JAX package's initial scope carried across and dropout 0, the
   first-step gradient of every parameter agrees within rtol 1e-4 / atol
   1e-5, and a 5-step Adam loss trajectory within rtol 1e-4, with
   label-smoothed (soft) and plain (hard) labels;
 - the Executor's generator advances from run to run and a fresh scope
   with the same seed replays it;
 - the model paths not ported yet (flash, ring, stacked, MoE) raise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP0_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
B, L = 4, 8


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(prog):
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _build(pkg, tm, label_smooth=0.1, dropout=0.1):
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    cfg.label_smooth, cfg.dropout = label_smooth, dropout
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


def test_same_training_program():
    ref_framework.fresh_session()
    rmain, rstart, rcost = _build(rf, ref_tm)
    pmain, pstart, pcost = _build(tf, port_tm)
    assert pcost.name == rcost.name
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)


def test_slice_op_types_are_registered():
    from paddle_tpu_torch.fluid.executor import _resolve

    pmain, pstart, _ = _build(tf, port_tm)
    types = {op.type for p in (pmain, pstart) for op in p.global_block().ops}
    assert {"adam", "softmax_with_cross_entropy", "dropout",
            "softmax_with_cross_entropy_grad", "dropout_grad",
            "lookup_table_grad", "gaussian_random"} <= types
    for t in types:
        _resolve(t)  # raises NotImplementedError for an unported op


@pytest.mark.parametrize("field,value", [
    ("flash_attention", True), ("ring_attention", True), ("stacked", True),
    ("moe_experts", 4)])
def test_unported_paths_raise(field, value):
    cfg = port_tm.tiny_config()
    setattr(cfg, field, value)
    with tf.program_guard(tf.Program(), tf.Program()), \
            pytest.raises(NotImplementedError, match=field):
        port_tm.build(cfg, src_len=L, tgt_len=L)


def test_config_takes_no_unported_fields():
    # recompute would otherwise be accepted and ignored
    with pytest.raises(TypeError):
        port_tm.Config("x", 10, 10, 8, 16, 2, 1, recompute=True)


def test_error_clip_raises_until_ported():
    with tf.program_guard(tf.Program(), tf.Program()):
        x = tf.layers.data("x", shape=[4], dtype="float32")
        h = tf.layers.fc(x, 3)
        h.error_clip = object()
        loss = tf.layers.reduce_sum(h)
        with pytest.raises(NotImplementedError, match="error_clip"):
            tf.optimizer.Adam(1e-3).minimize(loss)


# -- per-op gradients ---------------------------------------------------------

def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _soft(r, v, seed=2):
    y = np.random.default_rng(seed).random((r, v)).astype(np.float32)
    return y / y.sum(-1, keepdims=True)


def _hard(r, v, seed=2):
    lab = np.random.default_rng(seed).integers(0, v, (r, 1))
    lab[::3] = 1  # the ignored label of the ignore_index case
    return lab.astype(np.int64)


def _ids(*shape):
    # few distinct ids: repeats exercise the scatter-add
    return np.random.default_rng(3).integers(0, 5, shape).astype(np.int64)


# op name -> (fed inputs {name: array}, differentiable names,
#             build(layers, vars, ParamAttr)); "w" of lookup_table is a
#             parameter, set in the scope after the startup run
TABLE = _rand(5, 4)
GRAD_CASES = {
    "mul": ({"x": _rand(2, 3, 4), "y": _rand(4, 5, seed=1)}, ["x", "y"],
            lambda L, v, P: L.mul(v["x"], v["y"], x_num_col_dims=2)),
    "matmul": ({"x": _rand(2, 3, 4), "y": _rand(2, 5, 4, seed=1)},
               ["x", "y"],
               lambda L, v, P: L.matmul(v["x"], v["y"], transpose_y=True,
                                     alpha=0.5)),
    "elementwise_add": ({"x": _rand(2, 3, 4), "y": _rand(3, seed=1)},
                        ["x", "y"],
                        lambda L, v, P: L.elementwise_add(v["x"], v["y"],
                                                       axis=1)),
    "elementwise_mul": ({"x": _rand(2, 3, 4), "y": _rand(4, seed=1)},
                        ["x", "y"],
                        lambda L, v, P: L.elementwise_mul(v["x"], v["y"])),
    "elementwise_div": ({"x": _rand(2, 3), "y": _rand(2, 3, seed=1) + 3},
                        ["x", "y"],
                        lambda L, v, P: L.elementwise_div(v["x"], v["y"])),
    "scale": ({"x": _rand(3, 4)}, ["x"],
              lambda L, v, P: L.scale(v["x"], scale=0.7, bias=0.2)),
    "reshape": ({"x": _rand(2, 3, 4)}, ["x"],
                lambda L, v, P: L.reshape(v["x"], [-1, 4, 3])),
    "transpose": ({"x": _rand(2, 3, 4)}, ["x"],
                  lambda L, v, P: L.transpose(v["x"], perm=[2, 0, 1])),
    "relu": ({"x": _rand(3, 5)}, ["x"], lambda L, v, P: L.relu(v["x"])),
    "softmax": ({"x": _rand(3, 6)}, ["x"], lambda L, v, P: L.softmax(v["x"])),
    "layer_norm": ({"x": _rand(2, 3, 8)}, ["x"],
                   lambda L, v, P: L.layer_norm(v["x"], begin_norm_axis=2)),
    "reduce_sum": ({"x": _rand(2, 3, 4)}, ["x"],
                   lambda L, v, P: L.reduce_sum(v["x"], dim=1, keep_dim=True)),
    "cast": ({"x": _rand(3, 4)}, ["x"],
             lambda L, v, P: L.cast(v["x"], "float64")),
    "lookup_table": ({"ids": _ids(3, 2, 1)}, ["w"],
                     lambda L, v, P: L.embedding(v["ids"], size=[5, 4],
                                                 param_attr=P(name="w"))),
    "softmax_with_cross_entropy-soft": (
        {"x": _rand(6, 7), "label": _soft(6, 7)}, ["x"],
        lambda L, v, P: L.softmax_with_cross_entropy(v["x"], v["label"],
                                                  soft_label=True)),
    "softmax_with_cross_entropy-hard": (
        {"x": _rand(6, 7), "label": _hard(6, 7)}, ["x"],
        lambda L, v, P: L.softmax_with_cross_entropy(v["x"], v["label"],
                                                  ignore_index=1)),
}


def _op_grads(pkg, inputs, diff, build):
    """Build ``loss = reduce_sum(op(inputs) · w)`` (w a fixed random
    weight, so no grad vanishes by symmetry), append the backward and
    fetch ``d loss / d input`` for each differentiable input."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        v = {name: L.data(name, shape=list(arr.shape), dtype=str(arr.dtype),
                          append_batch_size=False,
                          stop_gradient=name not in diff)
             for name, arr in inputs.items()}
        out = build(L, v, pkg.ParamAttr)
        weight = L.assign(_rand(*out.shape, seed=9).astype(str(out.dtype)))
        loss = L.reduce_sum(L.elementwise_mul(out, weight))
        pkg.backward.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    if "w" in diff:
        if pkg is rf:
            scope.set("w", TABLE)
        else:
            port_tm.load_reference_params(scope, {"w": TABLE}, tf.CPUPlace())
    return [np.asarray(g) for g in exe.run(
        prog, feed=dict(inputs), fetch_list=[n + "@GRAD" for n in diff],
        scope=scope)]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_op_matches_reference(case):
    inputs, diff, build = GRAD_CASES[case]
    ref_framework.fresh_session()
    ref = _op_grads(rf, inputs, diff, build)
    port = _op_grads(tf, inputs, diff, build)
    for r, p, name in zip(ref, port, diff):
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_allclose(p, r, err_msg=name, **GRAD_TOL)


def test_dropout_grad_reuses_the_mask():
    """Different generators, so each package is held to ``dOut · Mask``
    with its own mask, and both keep about 1 - p of the elements."""
    x = _rand(64, 32)
    for pkg in (rf, tf):
        prog, startup = pkg.Program(), pkg.Program()
        prog.random_seed = 5
        with pkg.program_guard(prog, startup), pkg.unique_name.guard():
            xv = pkg.layers.data("x", shape=[64, 32], dtype="float32",
                                 append_batch_size=False, stop_gradient=False)
            out = pkg.layers.dropout(xv, dropout_prob=0.25)
            loss = pkg.layers.reduce_sum(pkg.layers.scale(out, scale=3.0))
            pkg.backward.append_backward(loss)
        mask_name = [op for op in prog.global_block().ops
                     if op.type == "dropout"][0].output("Mask")[0]
        exe = pkg.Executor(pkg.CPUPlace())
        got, mask, o = exe.run(prog, feed={"x": x},
                               fetch_list=["x@GRAD", mask_name, out],
                               scope=pkg.Scope())
        got, mask, o = np.asarray(got), np.asarray(mask), np.asarray(o)
        np.testing.assert_array_equal(got, 3.0 * mask)
        np.testing.assert_array_equal(o, x * mask)
        assert abs(mask.mean() - 0.75) < 0.03


# -- the whole slice ----------------------------------------------------------

def _feed():
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (B, L)),
            "tgt_word": rng.integers(1, 1000, (B, L)),
            "lbl_word": rng.integers(1, 1000, (B, L, 1))}
    feed["src_word"][0, -2:] = 0  # padding: the bias and the loss mask
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


def _train_both(label_smooth, steps):
    """Build the tiny slice (dropout 0) in both packages, carry the JAX
    package's initial persistables to the port, and run ``steps`` Adam
    steps on one batch.  Returns (ref, port) lists of per-step fetches:
    step 0 fetches the loss and every parameter grad, later steps the
    loss."""
    ref_framework.fresh_session()
    results = []
    init = None
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        main, startup, cost = _build(pkg, tm, label_smooth, dropout=0.0)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        persist = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:  # the JAX package's initial state, before a step
            init = {n: np.array(scope.get(n)) for n in persist}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        params = sorted(p.name for p in main.global_block().all_parameters()
                        if p.trainable)
        feed = _feed()
        out = []
        for step in range(steps):
            fetch = [cost] + ([p + "@GRAD" for p in params] if step == 0
                              else [])
            out.append([np.asarray(v) for v in
                        exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope)])
        results.append((params, out))
    return results


@pytest.mark.parametrize("label_smooth", [0.1, 0.0], ids=["soft", "hard"])
def test_training_matches_reference(label_smooth):
    (rparams, ref), (pparams, port) = _train_both(label_smooth, steps=5)
    assert pparams == rparams
    assert len(rparams) == 64  # 2 x 12 encoder, 2 x 18 decoder, 2 + 2
    for name, r, p in zip(rparams, ref[0][1:], port[0][1:]):
        assert p.shape == r.shape, name
        np.testing.assert_allclose(p, r, err_msg=name, **STEP0_TOL)
    ref_losses = np.array([s[0] for s in ref]).reshape(-1)
    port_losses = np.array([s[0] for s in port]).reshape(-1)
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
    assert port_losses[-1] < port_losses[0]


# -- the run generator --------------------------------------------------------

def _random_program():
    prog, startup = tf.Program(), tf.Program()
    prog.random_seed = startup.random_seed = 21
    with tf.program_guard(prog, startup), tf.unique_name.guard():
        x = tf.layers.data("x", shape=[256], dtype="float32",
                           append_batch_size=False)
        out = tf.layers.dropout(x, dropout_prob=0.5)
        w = tf.layers.create_parameter(
            [64], "float32", name="u",
            default_initializer=tf.initializer.UniformInitializer(-1, 1))
    return prog, startup, out, w


def test_executor_generator_advances_and_replays():
    prog, startup, out, w = _random_program()
    exe = tf.Executor(tf.CPUPlace())
    x = np.ones(256, np.float32)

    def session():
        scope = tf.Scope()
        exe.run(startup, scope=scope)
        init = scope.get("u").clone()
        draws = [exe.run(prog, feed={"x": x}, fetch_list=[out],
                         scope=scope)[0] for _ in range(3)]
        return init, draws

    init, draws = session()
    assert not np.array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[1], draws[2])
    init2, again = session()
    torch.testing.assert_close(init2, init, rtol=0, atol=0)
    for a, b in zip(again, draws):
        np.testing.assert_array_equal(a, b)
    # startup and main share one generator: a main run between two
    # startup runs moves the startup's draw
    scope = tf.Scope()
    exe.run(startup, scope=scope)
    exe.run(prog, feed={"x": x}, fetch_list=[out], scope=scope)
    exe.run(startup, scope=scope)
    assert not torch.equal(scope.get("u"), init)
