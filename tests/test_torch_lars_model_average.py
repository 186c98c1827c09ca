"""LARS (``layers.append_LARS``, ``Optimizer(LARS_weight_decay=...)``) and
``ModelAverage`` (``average_accumulates``) in the port against the JAX
package, on the CPU:

 - under Momentum and under Adam (the book's recognize_digits MLP, at a
   small width, with one parameter at its own learning rate) LARS builds
   the reference's Programs, its per-parameter rates and the losses
   follow the reference for 5 steps (rtol 1e-5 at step 0, 1e-4 after),
   and the update ops stay one run that the Executor groups;
 - ResNet-50 under LARS momentum with a model average builds the
   reference's Programs (the card's phase ``train_resnet_lars_amp``);
 - ModelAverage on the reference's own scenario (SGD on a linear fit,
   window 0.15 in [2, 10]): every sum and counter equal at each step,
   ``apply()``'s averages equal and ``restore()`` bitwise the trained
   values; the port's averages bitwise numpy's ``(s1 + s2 + s3) /
   total``;
 - the window test in float64 as the reference's: at rate 0.15 after 100
   updates and 15 accumulates the window closes in both packages (in
   float32 it would not), and the 16,384-update fold;
 - ``average_accumulates`` reads nothing to the host: it runs with the
   sync counters of a device tensor mocked to raise.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch.fluid import executor as port_executor
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models.params import load_reference_params

STEPS = 5
RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _program(prog):
    block = prog.global_block()
    ops = [(op.type, {s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if k != "op_callstack"})
           for op in block.ops]
    var_list = sorted((v.name, None if v.shape is None else tuple(v.shape),
                       str(v.dtype), v.persistable)
                      for v in block.vars.values())
    return ops, var_list


def _lars_mlp(pkg, opt):
    """The recognize_digits MLP at width 24 under ``opt`` with LARS; the
    second layer's weight at its own learning rate 0.5."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(img, 24, act="tanh")
        h = pkg.layers.fc(h, 24, act="tanh",
                          param_attr=pkg.ParamAttr(learning_rate=0.5))
        pred = pkg.layers.fc(h, 10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        if opt == "momentum":
            optimizer = pkg.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9, LARS_weight_decay=1e-4)
        else:
            optimizer = pkg.optimizer.Adam(learning_rate=1e-3,
                                           LARS_weight_decay=0.3)
        _, params_grads = optimizer.minimize(loss)
    lrs = [p.optimize_attr["learning_rate"].name for p, _ in params_grads]
    return main, startup, loss, lrs


def _run(pkg, main, startup, fetch, feeds, init=None):
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    out = [[np.array(v) for v in exe.run(main, feed=fd, fetch_list=fetch,
                                         scope=scope)]
           for fd in feeds]
    return out, init, exe, scope


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_lars_matches_reference(opt):
    rmain, rstart, rloss, rlrs = _lars_mlp(rf, opt)
    pmain, pstart, ploss, plrs = _lars_mlp(tf, opt)
    assert _program(pmain) == _program(rmain)
    assert _program(pstart) == _program(rstart)
    assert plrs == rlrs and len(plrs) == 6
    types = [op.type for op in pmain.global_block().ops]
    for t in ("square", "reduce_sum", "sqrt", "scale", "elementwise_mul",
              "elementwise_div", "elementwise_add"):
        assert t in types, t
    rng = np.random.RandomState(4)
    feeds = [chip_smoke.mnist_feed(rng, batch=16) for _ in range(STEPS)]
    ref, init, _, _ = _run(rf, rmain, rstart, [rloss] + rlrs, feeds)
    port, _, exe, _ = _run(tf, pmain, pstart, [ploss] + plrs, feeds, init)
    r = np.array([[float(v.reshape(-1)[0]) for v in s] for s in ref])
    p = np.array([[float(v.reshape(-1)[0]) for v in s] for s in port])
    assert np.all(np.abs(p - r) <= RTOL[:, None] * np.abs(r)), (p, r)
    assert (p[:, 1:] != 0).any() and len(set(p[:, 1])) > 1
    # the update ops stay one run, which the Executor groups
    update = "momentum" if opt == "momentum" else "adam"
    idx = [k for k, t in enumerate(types) if t == update]
    assert idx == list(range(idx[0], idx[0] + 6))
    plan = port_executor.BlockPlan(pmain, ["img", "label"], [ploss.name])
    assert [[plan.ops[k].type for k in run]
            for run in plan.groups.values()] == [[update] * 6]
    assert len(exe._plans) == 2  # startup and main


def test_lars_composes_with_a_rate_variable():
    """A second LARS pass finds each rate a Variable and multiplies it in
    (``elementwise_mul``), in both packages."""
    progs = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            loss = pkg.layers.mean(pkg.layers.fc(x, 2))
            pg = pkg.append_backward(loss)
            lr = pkg.layers.fill_constant([1], "float32", 0.1)
            sched = pkg.layers.learning_rate_scheduler
            sched.append_LARS(pg, lr, 0.5)
            sched.append_LARS(pg, lr, 1.0)
        progs.append(_program(main))
    assert progs[1] == progs[0]
    types = [op[0] for op in progs[1][0]]
    assert types.count("elementwise_mul") == 6 and types.count("scale") == 2


def test_resnet50_lars_model_average_program_matches_reference():
    rp = chip_smoke.resnet_lars_programs(rf, ref_resnet, image_hw=64,
                                         class_dim=10)
    port_framework.fresh_session()
    pp = chip_smoke.resnet_lars_programs(tf, port_resnet, image_hw=64,
                                         class_dim=10)
    for k in ("main", "startup", "test"):
        assert _program(pp[k]) == _program(rp[k]), k
    assert pp["lrs"] == rp["lrs"] and len(pp["lrs"]) == 161
    types = [op.type for op in pp["main"].global_block().ops]
    assert types.count("average_accumulates") == 161
    plan = port_executor.BlockPlan(pp["main"], ["img", "label"],
                                   [pp["loss"].name])
    assert sorted((plan.ops[run[0]].type, len(run))
                  for run in plan.groups.values()) == [
        ("average_accumulates", 161), ("momentum", 161)]
    assert not {"momentum", "average_accumulates"} & {
        op.type for op in pp["test"].global_block().ops}


def _ma_program(pkg):
    """The reference's ModelAverage scenario (its tests/test_misc_ops.py):
    a linear fit under SGD(0.1), ModelAverage(0.15, 2, 10)."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 2
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ma = pkg.optimizer.ModelAverage(0.15, min_average_window=2,
                                        max_average_window=10)
    return main, startup, loss, ma


def _ma_state(ma):
    return [ma._get_accumulator(n, p).name for p, _ in ma.params_grads
            for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                      "old_num_accumulates", "num_updates")]


def test_model_average_matches_reference_scenario():
    rmain, rstart, rloss, rma = _ma_program(rf)
    pmain, pstart, ploss, pma = _ma_program(tf)
    assert _program(pmain) == _program(rmain)
    assert _program(pstart) == _program(rstart)
    names = _ma_state(pma)
    assert names == _ma_state(rma)
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(12):
        xa = rng.normal(size=(16, 4)).astype(np.float32)
        feeds.append({"x": xa, "y": xa.sum(1, keepdims=True)})
    params = [p.name for p, _ in pma.params_grads]
    fetch = [ploss.name] + names + params
    ref, init, _, rscope = _run(rf, rmain, rstart, fetch, feeds)
    port, _, exe, pscope = _run(tf, pmain, pstart, fetch, feeds, init)
    closes = 0
    for step, (r, p) in enumerate(zip(ref, port)):
        for n, rv, pv in zip(fetch, r, p):
            if rv.dtype == np.int64:
                assert np.array_equal(pv, rv), (step, n)
            else:
                np.testing.assert_allclose(pv, rv, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{n} step {step}")
        closes += int(p[fetch.index(names[3])].reshape(-1)[0] == 0)
    assert closes >= 2  # windows closed within the run
    trained = {n: pscope.get(n) for n in params}
    copies = {n: t.clone() for n, t in trained.items()}
    with rf.scope_guard(rscope), rma.apply():
        ref_avg = {n: np.array(rscope.get(n)) for n in params}
    with tf.scope_guard(pscope):
        with pma.apply(exe):
            port_avg = {n: pscope.get(n).numpy().copy() for n in params}
            for (p, _), n in zip(pma.params_grads, params):
                s1, s2, s3, na, ona, _ = (
                    pscope.get(pma._get_accumulator(a, p).name).numpy()
                    for a in pma._SUMS + pma._COUNTS)
                total = float(na.reshape(-1)[0]) + float(ona.reshape(-1)[0])
                want = (s1 + s2 + s3) / total
                assert want.dtype == np.float32
                assert np.array_equal(port_avg[n], want), n
        for n in params:
            assert pscope.get(n) is trained[n]
            assert torch.equal(trained[n], copies[n])
    for n in params:
        np.testing.assert_allclose(port_avg[n], ref_avg[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        assert not np.allclose(port_avg[n], copies[n].numpy())


def _one_op(pkg, window, counts, shape=(3, 2)):
    """One ``average_accumulates`` op over a parameter of ``shape``, run
    once from seeded sums and ``counts`` (num_accumulates,
    old_num_accumulates, num_updates): the new state by name."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        pkg.layers.create_parameter(list(shape), "float32", name="w")
        ma = pkg.optimizer.ModelAverage(window, min_average_window=2,
                                        max_average_window=10000)
    names = _ma_state(ma)
    rng = np.random.default_rng(3)
    state = {"w": rng.standard_normal(shape, dtype=np.float32)}
    for n in names[:3]:
        state[n] = rng.standard_normal(shape, dtype=np.float32)
    for n, c in zip(names[3:], counts):
        state[n] = np.array([c], np.int64)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if pkg is tf:
        load_reference_params(scope, state, tf.CPUPlace())
    else:
        import jax.numpy as jnp

        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
    exe.run(main, scope=scope)
    return state, names, {n: np.array(scope.get(n)) for n in names}


@pytest.mark.parametrize("pkg", [rf, tf], ids=["reference", "port"])
def test_window_test_is_float64(pkg):
    """0.15 x 100 is 15.000000954 in float32, 15 in float64: after the
    100th update with 15 accumulates the window closes."""
    assert float(np.float32(0.15) * np.float32(100)) > 15.0
    state, names, got = _one_op(pkg, 0.15, (14, 3, 99))
    s1, s2, s3 = (state[n] for n in names[:3])
    assert got[names[3]].tolist() == [0]  # num_accumulates restarts
    assert got[names[4]].tolist() == [15]
    assert got[names[5]].tolist() == [100]
    np.testing.assert_array_equal(got[names[2]], (s1 + state["w"]) + s2)
    assert not got[names[0]].any() and not got[names[1]].any()


@pytest.mark.parametrize("pkg", [rf, tf], ids=["reference", "port"])
def test_sum_1_folds_into_sum_2_every_16384_updates(pkg):
    state, names, got = _one_op(pkg, 0.0, (0, 0, 16383))
    s1, s2, s3 = (state[n] for n in names[:3])
    # 1 accumulate is below the window's minimum: only the fold
    assert got[names[3]].tolist() == [1]
    assert got[names[5]].tolist() == [16384]
    assert not got[names[0]].any()
    np.testing.assert_array_equal(got[names[1]], s2 + (s1 + state["w"]))
    np.testing.assert_array_equal(got[names[2]], s3)


def test_average_accumulates_reads_nothing_to_the_host(monkeypatch):
    """Every branch on the device: no ``item`` / ``bool`` / ``tolist`` /
    ``cpu`` / ``numpy`` on a tensor inside the op."""
    state, names, want = _one_op(tf, 0.15, (14, 3, 99))
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        tf.layers.create_parameter([3, 2], "float32", name="w")
        tf.optimizer.ModelAverage(0.15, min_average_window=2,
                                  max_average_window=10000)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    load_reference_params(scope, state, tf.CPUPlace())

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside average_accumulates")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    exe.run(main, scope=scope)
    monkeypatch.undo()
    for n in names:
        assert np.array_equal(np.array(scope.get(n)), want[n]), n
