"""``Executor.run`` of the port against the JAX package's, on the CPU:

 - fetches are snapshots: a parameter fetched after one step keeps its
   value through two more steps (the momentum op updates the scope's
   tensor in place), and writing into a fetched array leaves the scope
   as it was;
 - a fed ``torch.Tensor`` for a name that an op updates in place is not
   written (the scope gets an updated copy), while the run's numbers equal
   those of a numpy feed;
 - ``feed_var_name``, ``fetch_var_name``, ``return_numpy=False`` and
   ``use_program_cache=False`` are taken by both packages with the same
   results (values compared: the two return different array types);
 - ``fluid.scope_guard`` redirects ``global_scope()`` in both packages
   and restores it on leaving.

The model: ``fc`` (no bias, constant 0.5 weights) + ``mean`` +
``Momentum(0.1, 0.9)`` on a ``[4, 4]`` feed, the same from both packages'
builders.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework

X = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _build(fluid):
    """(main, startup, loss) of the tiny momentum model in ``fluid``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        y = fluid.layers.fc(x, size=1, bias_attr=False,
                            param_attr=fluid.ParamAttr(
                                name="w",
                                initializer=fluid.initializer.Constant(0.5)))
        loss = fluid.layers.mean(y)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _port_exe():
    return tf.Executor(tf.CPUPlace())


def _ref_exe():
    return rf.Executor(rf.CPUPlace())


def _values(fetched):
    """Numpy values of what either package's ``run`` returned."""
    out = []
    for v in fetched:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out.append(np.array(np.asarray(v), dtype=np.float32))
    return out


@pytest.mark.parametrize("fluid,make_exe", [(tf, _port_exe),
                                            (rf, _ref_exe)],
                         ids=["port", "reference"])
def test_fetched_parameter_is_a_snapshot(fluid, make_exe):
    main, startup, loss = _build(fluid)
    exe = make_exe()
    exe.run(startup)
    (w1,) = exe.run(main, feed={"x": X}, fetch_list=["w"])
    kept = np.array(w1, copy=True)
    for _ in range(2):
        (w3,) = exe.run(main, feed={"x": X}, fetch_list=["w"])
    np.testing.assert_array_equal(w1, kept)
    assert not np.array_equal(w3, w1), "the runs did not train w"


def test_writing_into_a_fetch_leaves_the_scope():
    main, startup, loss = _build(tf)
    exe = _port_exe()
    exe.run(startup)
    w, v = exe.run(main, feed={"x": X},
                   fetch_list=["w", "velocity_w_0"])
    before = tf.global_scope().get("w").clone()
    vel_before = tf.global_scope().get("velocity_w_0").clone()
    w[...] = 7.0
    v[...] = 7.0
    torch.testing.assert_close(tf.global_scope().get("w"), before,
                               rtol=0, atol=0)
    torch.testing.assert_close(tf.global_scope().get("velocity_w_0"),
                               vel_before, rtol=0, atol=0)


def test_fed_tensor_updated_in_place_is_not_written():
    main, startup, loss = _build(tf)
    exe = _port_exe()
    exe.run(startup)
    fed = torch.ones(4, 1)
    (l_t,) = exe.run(main, feed={"x": X, "w": fed}, fetch_list=[loss])
    torch.testing.assert_close(fed, torch.ones(4, 1), rtol=0, atol=0)
    w_after = tf.global_scope().get("w")
    assert w_after.data_ptr() != fed.data_ptr()

    # the same run with a numpy feed gives the same loss and update
    port_framework.fresh_session()
    main, startup, loss = _build(tf)
    exe = _port_exe()
    exe.run(startup)
    (l_np,) = exe.run(main, feed={"x": X, "w": np.ones((4, 1), np.float32)},
                      fetch_list=[loss])
    np.testing.assert_array_equal(l_t, l_np)
    torch.testing.assert_close(w_after, tf.global_scope().get("w"),
                               rtol=0, atol=0)


def test_fed_tensor_no_op_writes_is_not_copied():
    """Only the names an op updates in place are cloned: the plan lists
    ``w`` and its velocity (momentum's outputs) and not the learning rate,
    which the op only reads."""
    main, startup, loss = _build(tf)
    exe = _port_exe()
    exe.run(startup)
    lr_name = next(n for n in main.global_block().vars
                   if n.startswith("learning_rate"))
    lr = torch.full((1,), 0.1)
    exe.run(main, feed={"x": X, lr_name: lr}, fetch_list=[loss])
    (plan,) = [p for key, p in exe._plans.items()
               if key[0] == main._cache_token]
    assert plan.in_place_names == {"w", "velocity_w_0"}
    assert lr_name not in plan.in_place_names


def _three_steps(fluid, make_exe, **kwargs):
    main, startup, loss = _build(fluid)
    exe = make_exe()
    exe.run(startup)
    return [_values(exe.run(main, feed={"x": X}, fetch_list=[loss, "w"],
                            **kwargs)) for _ in range(3)], exe, main


@pytest.mark.parametrize("kwargs", [
    {"feed_var_name": "my_feed"},
    {"fetch_var_name": "my_fetch"},
    {"return_numpy": False},
    {"use_program_cache": False},
], ids=["feed_var_name", "fetch_var_name", "return_numpy", "program_cache"])
def test_run_keyword_arguments_match_reference(kwargs):
    port, port_exe, main = _three_steps(tf, _port_exe, **kwargs)
    ref_framework.fresh_session()
    ref, _, _ = _three_steps(rf, _ref_exe, **kwargs)
    for got, want in zip(port, ref):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    if kwargs.get("use_program_cache") is False:
        # only the startup run, made with the cache, left a plan
        assert not any(key[0] == main._cache_token
                       for key in port_exe._plans)


def test_return_numpy_false_gives_tensor_snapshots():
    main, startup, loss = _build(tf)
    exe = _port_exe()
    exe.run(startup)
    (w1,) = exe.run(main, feed={"x": X}, fetch_list=["w"],
                    return_numpy=False)
    assert isinstance(w1, torch.Tensor)
    kept = w1.clone()
    exe.run(main, feed={"x": X}, fetch_list=["w"])
    torch.testing.assert_close(w1, kept, rtol=0, atol=0)
    assert w1.data_ptr() != tf.global_scope().get("w").data_ptr()


def test_positional_arguments_keep_the_reference_order():
    """``run(program, feed, fetch_list, feed_var_name, fetch_var_name,
    scope)``: the sixth positional argument is the scope in both."""
    for fluid, make_exe in ((tf, _port_exe), (rf, _ref_exe)):
        main, startup, loss = _build(fluid)
        exe = make_exe()
        scope = fluid.Scope()
        exe.run(startup, None, None, "feed", "fetch", scope)
        (w,) = exe.run(main, {"x": X}, ["w"], "feed", "fetch", scope)
        assert w.shape == (4, 1)
        assert fluid.global_scope().get("w") is None


@pytest.mark.parametrize("fluid", [tf, rf], ids=["port", "reference"])
def test_scope_guard_redirects_global_scope(fluid):
    outer = fluid.global_scope()
    inner = fluid.Scope()
    with fluid.scope_guard(inner):
        assert fluid.global_scope() is inner
        assert fluid.executor.global_scope() is inner
    assert fluid.global_scope() is outer


def test_scope_guard_runs_into_the_guarded_scope():
    results = []
    for fluid, make_exe in ((tf, _port_exe), (rf, _ref_exe)):
        main, startup, loss = _build(fluid)
        exe = make_exe()
        inner = fluid.Scope()
        with fluid.scope_guard(inner):
            exe.run(startup)
            results.append(_values(exe.run(main, feed={"x": X},
                                           fetch_list=[loss, "w"])))
        assert inner.get("w") is not None
        assert fluid.global_scope().get("w") is None
    for g, w in zip(*results):
        np.testing.assert_allclose(g, w, **TOL)
