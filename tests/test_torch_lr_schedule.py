"""The port's learning-rate schedules and the ops they emit, against the
JAX package, on the CPU:

 - each schedule (noam, exponential with and without staircase,
   natural_exp, inverse_time, polynomial with and without cycle,
   piecewise, cosine) builds the same main and startup Programs (op
   types, slots, attrs; exact) and gives the same learning rate at each of
   12 runs (rtol 1e-6: float32 on both sides, exp / pow / cos of another
   library);
 - the ops new in the port (increment, elementwise_sub / max / min / pow,
   less_than / less_equal / greater_than / greater_equal, exp, floor, ceil,
   cos) give the reference's outputs, and where they have grads the
   reference's grads (rtol 1e-5, atol 1e-6), ties of max / min included;
 - the operators of ``math_op_patch`` on ``Variable`` build the
   reference's ops;
 - ``append_LARS`` builds the reference's ops and gives its rates, and
   ``transformer.build(warmup_steps=)`` builds the reference's noam
   Program.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.models.params import load_reference_params

RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(prog):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


SCHEDULES = {
    "noam": lambda L: L.noam_decay(512, 4),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 0.001, 2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 0.001, 2.0,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6, 9],
                                             [1.0, 0.5, 0.25, 0.1]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
}


def _schedule(pkg, make, steps=12):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        lr = make(pkg.layers.learning_rate_scheduler)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    values = [float(np.asarray(exe.run(main, fetch_list=[lr],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    return main, startup, values


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_program_and_values_match_reference(name):
    rmain, rstart, rvals = _schedule(rf, SCHEDULES[name])
    pmain, pstart, pvals = _schedule(tf, SCHEDULES[name])
    assert _ops(pmain) == _ops(rmain)
    assert _ops(pstart) == _ops(rstart)
    assert "increment" in [op.type for op in pmain.global_block().ops]
    np.testing.assert_allclose(pvals, rvals, rtol=RTOL)
    assert len(set(pvals)) > 1  # the rate moves with the step


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_X, _Y = _rand(3, 4), _rand(3, 4, seed=1)
_TIES = _X.copy()
_TIES[0] = _Y[0]  # a row of ties: max / min split the grad evenly
_POS = np.abs(_rand(3, 4, seed=2)) + 0.5

# name -> (fed inputs, differentiable names, build(layers, vars))
CASES = {
    "elementwise_sub": ({"x": _X, "y": _rand(4, seed=1)}, ["x", "y"],
                        lambda L, v: L.elementwise_sub(v["x"], v["y"])),
    "elementwise_max": ({"x": _TIES, "y": _Y}, ["x", "y"],
                        lambda L, v: L.elementwise_max(v["x"], v["y"])),
    "elementwise_min": ({"x": _TIES, "y": _Y}, ["x", "y"],
                        lambda L, v: L.elementwise_min(v["x"], v["y"])),
    "elementwise_pow": ({"x": _POS, "y": _rand(3, 4, seed=3)}, ["x", "y"],
                        lambda L, v: L.elementwise_pow(v["x"], v["y"])),
    "exp": ({"x": _X}, ["x"], lambda L, v: L.exp(v["x"])),
    "cos": ({"x": _X}, ["x"], lambda L, v: L.cos(v["x"])),
    "floor": ({"x": _X * 3}, ["x"], lambda L, v: L.floor(v["x"])),
    "ceil": ({"x": _X * 3}, ["x"], lambda L, v: L.ceil(v["x"])),
}


def _op_grads(pkg, inputs, diff, build):
    """``op(inputs)`` and ``d reduce_sum(op · w) / d input`` for each
    differentiable input (w a fixed random weight)."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        v = {name: L.data(name, shape=list(arr.shape), dtype=str(arr.dtype),
                          append_batch_size=False,
                          stop_gradient=name not in diff)
             for name, arr in inputs.items()}
        out = build(L, v)
        weight = L.assign(_rand(*out.shape, seed=9))
        loss = L.reduce_sum(L.elementwise_mul(out, weight))
        pkg.backward.append_backward(loss)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(g) for g in exe.run(
        prog, feed=dict(inputs),
        fetch_list=[out] + [n + "@GRAD" for n in diff], scope=scope)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_op_outputs_and_grads_match_reference(case):
    inputs, diff, build = CASES[case]
    ref = _op_grads(rf, inputs, diff, build)
    port_framework.fresh_session()
    port = _op_grads(tf, inputs, diff, build)
    for r, p, name in zip(ref, port, ["out"] + diff):
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_allclose(p, r, err_msg=name, **GRAD_TOL)


def _compare_and_increment(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[3, 4], dtype="float32",
                   append_batch_size=False)
        y = L.data("y", shape=[3, 4], dtype="float32",
                   append_batch_size=False)
        outs = [x < y, x <= y, x > y, x >= y]
        counter = L.autoincreased_step_counter(counter_name="c", begin=3,
                                               step=2)
        outs.append(counter)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    got = [exe.run(prog, feed={"x": _TIES, "y": _Y}, fetch_list=outs,
                   scope=scope) for _ in range(3)]
    return prog, [[np.asarray(v) for v in run] for run in got]


def test_compare_and_increment_match_reference():
    rprog, ref = _compare_and_increment(rf)
    port_framework.fresh_session()
    pprog, port = _compare_and_increment(tf)
    assert _ops(pprog) == _ops(rprog)
    for r_run, p_run in zip(ref, port):
        for r, p in zip(r_run, p_run):
            assert p.dtype == r.dtype
            np.testing.assert_array_equal(p, r)
    assert [int(run[-1][0]) for run in port] == [4, 6, 8]


def test_increment_keeps_large_integer_counts():
    import torch

    from paddle_tpu_torch.fluid.executor import run_op
    from paddle_tpu_torch.fluid.framework import Operator

    prog = tf.Program()
    op = Operator(prog.global_block(), "increment", inputs={"X": ["c"]},
                  outputs={"Out": ["c"]}, attrs={"step": 1.0})
    env = {"c": torch.tensor([2 ** 40 + 1], dtype=torch.int64)}
    run_op(op, env, torch.device("cpu"))
    assert env["c"].dtype == torch.int64
    assert int(env["c"][0]) == 2 ** 40 + 2


def _operators(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[4], dtype="float32")
        outs = [x + y, x - y, x * y, x / y, x ** y, x + 2.0, 2.0 + x,
                x - 1.5, 3.0 - x, x * 0.5, 0.5 * x, x / 4.0, 4.0 / x,
                x ** 2.0, 2.0 ** x, -x, x < 1.0, x <= y, x > y, x >= 0.0]
    return prog, outs


def test_variable_operators_build_reference_ops():
    rprog, routs = _operators(rf)
    port_framework.fresh_session()
    pprog, pouts = _operators(tf)
    assert _ops(pprog) == _ops(rprog)
    assert [str(o.dtype) for o in pouts] == [str(o.dtype) for o in routs]
    feed = {"x": np.abs(_rand(2, 4)) + 0.5, "y": _rand(2, 4, seed=1)}
    got = []
    for pkg, prog, outs in ((rf, rprog, routs), (tf, pprog, pouts)):
        exe = pkg.Executor(pkg.CPUPlace())
        got.append([np.asarray(v) for v in exe.run(
            prog, feed=feed, fetch_list=outs, scope=pkg.Scope())])
    for i, (r, p) in enumerate(zip(*got)):
        np.testing.assert_allclose(p, r, rtol=RTOL, err_msg=str(i))


def _lars(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 2
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        h = pkg.layers.fc(x, 3, act="tanh",
                          param_attr=pkg.ParamAttr(learning_rate=2.0))
        loss = pkg.layers.mean(pkg.layers.fc(h, 2))
        params_grads = pkg.append_backward(loss)
        lr = pkg.layers.fill_constant([1], "float32", 0.1)
        pkg.layers.learning_rate_scheduler.append_LARS(params_grads, lr, 0.1)
    return main, startup, [p.optimize_attr["learning_rate"]
                           for p, _ in params_grads]


def test_append_lars_raises():
    """``append_LARS`` builds the reference's ops (a parameter's own rate
    through ``scale``) and gives its rates: ``lr·‖p‖ / (‖g‖ + 0.1·‖p‖)``
    per parameter."""
    got = []
    for pkg in (rf, tf):
        main, startup, rates = _lars(pkg)
        got.append((_ops(main), main, startup, rates))
    assert got[1][0] == got[0][0]
    feed = {"x": _rand(5, 4, seed=4)}
    vals = []
    for pkg, (_, main, startup, rates) in zip((rf, tf), got):
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if pkg is tf:
            load_reference_params(scope, init, tf.CPUPlace())
        else:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        vals.append([float(np.asarray(v).reshape(-1)[0]) for v in exe.run(
            main, feed=feed, fetch_list=rates, scope=scope)])
    assert len(vals[1]) == 4 and min(vals[1]) >= 0 and max(vals[1]) > 0
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)


def test_transformer_warmup_builds_reference_noam():
    progs = []
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        cfg = tm.tiny_config()
        cfg.flash_attention = False
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            tm.build(cfg, src_len=8, tgt_len=8, warmup_steps=8)
        progs.append((_ops(main), _ops(startup)))
    assert progs[1] == progs[0]
    assert any(op[0] == "increment" for op in progs[1][0])
