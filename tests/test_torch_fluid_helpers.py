"""The small Fluid helpers of the port against the JAX package, on the
CPU: ``layers.generate_layer_fn`` (over registered ops, its error for an
unregistered one), ``autodoc``, ``templatedoc``, ``deprecated``'s warning,
``fluid.name_scope``, ``initializer.init_on_cpu`` /
``force_init_on_cpu``, ``WeightNormParamAttr``, the memory transpiler's
``memory_optimize`` / ``release_memory`` and ``average.WeightedAverage``:
each behaves as the reference's, and each name the reference exports is
exported."""

import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _ops(prog):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: v for k, v in op.attrs.items() if k != "op_callstack"})
            for op in prog.global_block().ops]


@pytest.mark.parametrize("name", [
    "generate_layer_fn", "autodoc", "templatedoc", "deprecated",
    "layer_function_generator"])
def test_layers_export_the_generator(name):
    assert hasattr(rf.layers, name) and hasattr(tf.layers, name)


@pytest.mark.parametrize("name", [
    "name_scope", "WeightNormParamAttr", "memory_optimize",
    "release_memory", "average"])
def test_fluid_exports(name):
    assert hasattr(tf, name) and name in tf.__all__
    assert hasattr(rf, name)


def test_transpiler_exports_memory_functions():
    for fn in ("memory_optimize", "release_memory"):
        assert getattr(tf.transpiler, fn) is getattr(tf, fn)
        assert fn in tf.transpiler.__all__


@pytest.mark.parametrize("op,attrs", [
    ("tanh", {}), ("leaky_relu", {"alpha": 0.1}), ("softsign", {}),
    ("sign", {})])
def test_generate_layer_fn_matches_reference(op, attrs):
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    got = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            layer = pkg.layers.generate_layer_fn(op)
            v = pkg.layers.data("x", shape=[5], dtype="float32")
            out = layer(v, **attrs)
        assert layer.__name__ == op and op in layer.__doc__
        exe = pkg.Executor(pkg.CPUPlace())
        res = exe.run(main, feed={"x": x}, fetch_list=[out],
                      scope=pkg.Scope())[0]
        got.append((_ops(main), out.shape, np.asarray(res)))
    assert got[1][0] == got[0][0] and got[1][1] == got[0][1]
    np.testing.assert_allclose(got[1][2], got[0][2], rtol=1e-6, atol=1e-7)


def test_generate_layer_fn_refuses_unregistered_op():
    for pkg in (rf, tf):
        with pytest.raises(ValueError, match="not registered"):
            pkg.layers.generate_layer_fn("no_such_op")


def test_autodoc_and_templatedoc_as_reference():
    for pkg in (rf, tf):
        gen = pkg.layers.layer_function_generator

        @gen.autodoc("Prefix.")
        def a():
            """Body."""

        @gen.templatedoc("relu")
        def b():
            """${comment} applied."""

        @gen.templatedoc()
        def c():
            """${comment} kept."""

        assert (a.__doc__, b.__doc__, c.__doc__) == (
            "Prefix.\nBody.", "relu applied.", "${comment} kept.")


def test_deprecated_warns_as_reference():
    msgs = []
    for pkg in (rf, tf):
        @pkg.layers.deprecated(since="1.2", instead="fc")
        def old(x):
            return x + 1

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert old(1) == 2
        assert [w.category for w in caught] == [DeprecationWarning]
        msgs.append(str(caught[0].message))
        assert old.__name__ == "old"
    assert msgs[1] == msgs[0] == "old is deprecated since 1.2; use fc instead"


def test_name_scope_changes_nothing():
    progs = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            with pkg.name_scope("block"):
                with pkg.name_scope():
                    y = pkg.layers.fc(x, 2)
            pkg.layers.mean(y)
        progs.append(_ops(main))
    assert progs[1] == progs[0]


def test_init_on_cpu_is_a_no_op():
    """Inside ``init_on_cpu()`` the startup program is the same and the
    parameters are made on the startup's place, in both packages."""
    from paddle_tpu.fluid import initializer as ref_init
    from paddle_tpu_torch.fluid import initializer as port_init

    assert port_init.force_init_on_cpu() is ref_init.force_init_on_cpu() \
        is False
    progs = []
    for pkg, init in ((rf, ref_init), (tf, port_init)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            with init.init_on_cpu():
                pkg.layers.fc(x, 2)
        progs.append((_ops(main), _ops(startup)))
        if pkg is tf:
            scope = tf.Scope()
            tf.Executor(tf.CPUPlace()).run(startup, scope=scope)
            assert scope.get("fc_0.w_0").device.type == "cpu"
    assert progs[1] == progs[0]


def test_weight_norm_param_attr_holds_dim():
    for pkg in (rf, tf):
        attr = pkg.WeightNormParamAttr(dim=1, name="w", learning_rate=0.5)
        assert isinstance(attr, pkg.ParamAttr)
        assert (attr.dim, attr.name, attr.learning_rate) == (1, "w", 0.5)
        assert pkg.WeightNormParamAttr().dim is None
    progs = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            pkg.layers.fc(x, 2, param_attr=pkg.WeightNormParamAttr(
                dim=0, name="wn"))
        progs.append(_ops(main))
    assert progs[1] == progs[0]


def test_memory_optimize_returns_the_program_unchanged(capsys):
    feed = {"x": np.ones((2, 4), np.float32)}
    out = []
    for pkg in (rf, tf):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            loss = pkg.layers.mean(pkg.layers.fc(x, 2))
        before = _ops(main)
        assert pkg.memory_optimize(main, print_log=True) is main
        assert pkg.release_memory(main, skip_opt_set={"x"}) is main
        assert _ops(main) == before
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if pkg is tf:
            load_reference_params(scope, init, tf.CPUPlace())
        else:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        out.append(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0]))
    assert "memory_optimize" in capsys.readouterr().out
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)


@pytest.mark.parametrize("values", [
    [(1.0, 2.0), (3.0, 1.0), (0.5, 4.0)],
    [(np.array([1.0, 2.0]), 1.0), (np.array([3.0, -1.0]), 3.0)]],
    ids=["scalars", "arrays"])
def test_weighted_average_as_reference(values):
    got = []
    for pkg in (rf, tf):
        avg = pkg.average.WeightedAverage()
        for v, w in values:
            avg.add(v, weight=w)
        got.append(avg.eval())
        avg.reset()
        with pytest.raises(ValueError, match="no data"):
            avg.eval()
    assert type(got[1]) is type(got[0])
    np.testing.assert_array_equal(got[1], got[0])
