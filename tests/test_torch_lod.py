"""LoD, feeding, flags and the Executor's debugging and pruning paths of
the port against the JAX package, on the CPU:

 - ``LoDTensor``, ``create_lod_tensor``, ``create_random_int_lodtensor``
   and ``DataFeeder`` give the same arrays, LoDs and validity answers;
 - a ``LoDTensor`` or ``(array, lengths)`` feed runs as its data does;
   ``run(return_numpy=False)`` fetches wrap into a ``LoDTensor`` that
   numpy reads;
 - ``_flag_value`` / ``init_gflags`` parse as the reference does, and
   ``FLAGS_check_nan_inf`` raises ``FloatingPointError`` naming the same
   first variable, in ``run`` and in ``run_steps``;
 - a mixed program whose unfed data var lies in a branch nobody fetches is
   pruned to the fetch targets (``_prune_for_unfed``), and a fetch that
   needs the unfed var still raises;
 - the MNIST mlp ``save_load_inference_roundtrip`` of
   ``tests/test_mnist_mlp.py`` on the port, and its outputs against the
   reference's from the same state.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid.executor import _prune_for_unfed
from paddle_tpu_torch.models import mnist as port_mnist

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


@pytest.mark.parametrize("data,lens", [
    (np.arange(10, dtype=np.float32).reshape(5, 2), [[2, 3]]),
    ([[1, 2], [3, 4, 5]], [[2, 3]]),
    (np.arange(6, dtype=np.int64).reshape(6, 1), [[1, 2], [2, 1, 3]]),
], ids=["array", "ragged_list", "two_levels"])
def test_create_lod_tensor_matches_reference(data, lens):
    r = rf.create_lod_tensor(data, lens, rf.CPUPlace())
    p = tf.create_lod_tensor(data, lens, tf.CPUPlace())
    np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    assert np.asarray(p).dtype == np.asarray(r).dtype
    assert p.lod() == r.lod() and p.shape == r.shape
    assert p.recursive_sequence_lengths() == r.recursive_sequence_lengths()
    assert p.has_valid_recursive_sequence_lengths()
    again = tf.create_lod_tensor(p, [[5]] if len(lens) == 1 else lens)
    assert again.has_valid_recursive_sequence_lengths()


def test_lod_tensor_surface_matches_reference():
    for pkg in (rf, tf):
        with pytest.raises(ValueError, match="invalid lod"):
            pkg.create_lod_tensor(np.zeros((4, 1)), [[2, 3]])
    r, p = rf.LoDTensor(), tf.LoDTensor()
    for t in (r, p):
        t.set(np.ones((3, 2), np.float32), None)
        t.set_lod([[0, 1, 3]])
    assert p.lod() == r.lod() == ((0, 1, 3),)
    assert p.recursive_sequence_lengths() == [[1, 2]]
    assert p.has_valid_recursive_sequence_lengths() == \
        r.has_valid_recursive_sequence_lengths() is True
    p.set_recursive_sequence_lengths([[2, 2]])
    r.set_recursive_sequence_lengths([[2, 2]])
    assert p.has_valid_recursive_sequence_lengths() == \
        r.has_valid_recursive_sequence_lengths() is False
    t = tf.LoDTensor(torch.arange(4, dtype=torch.bfloat16), [[0, 4]])
    assert t.shape == (4,)
    np.testing.assert_array_equal(np.asarray(t),
                                  np.arange(4, dtype=np.float32))


def test_random_int_lodtensor_matches_reference():
    np.random.seed(3)
    r = rf.create_random_int_lodtensor([[2, 3]], [2], rf.CPUPlace(), 0, 9)
    np.random.seed(3)
    p = tf.create_random_int_lodtensor([[2, 3]], [2], tf.CPUPlace(), 0, 9)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    assert p.lod() == r.lod() and np.asarray(p).shape == (5, 2)


def _feeder_vars(fluid):
    img = fluid.layers.data(name="img", shape=[2, 3], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    return [img, label, words]


def test_data_feeder_matches_reference():
    rng = np.random.RandomState(0)
    batch = [(rng.normal(size=(2, 3)).astype(np.float32), [k],
              [[w] for w in range(k + 1)]) for k in range(3)]
    out = []
    for fluid, fresh in ((rf, ref_framework.fresh_session),
                         (tf, port_framework.fresh_session)):
        fresh()
        feeder = fluid.DataFeeder(_feeder_vars(fluid), fluid.CPUPlace())
        by_name = fluid.DataFeeder(["img", "label", "words"],
                                   fluid.CPUPlace())
        out.append((feeder.feed(batch), by_name.feed(batch)))
    (rfed, rnamed), (pfed, pnamed) = out
    for fed in (pfed, pnamed):
        assert sorted(fed) == sorted(rfed)
        for k in rfed:
            np.testing.assert_array_equal(np.asarray(fed[k]),
                                          np.asarray(rfed[k]))
            assert np.asarray(fed[k]).dtype == np.asarray(rfed[k]).dtype
        assert isinstance(fed["words"], tf.LoDTensor)
        assert fed["words"].lod() == rfed["words"].lod() == ((0, 1, 3, 6),)
    with pytest.raises(TypeError, match="Variables or names"):
        tf.DataFeeder([3], tf.CPUPlace())


def _fc_mean_sgd(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = fluid.layers.fc(input=x, size=3, param_attr=fluid.ParamAttr(
        name="w", initializer=fluid.initializer.Constant(0.5)))
    loss = fluid.layers.mean(h)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return x, h, loss


def test_lod_and_tuple_feeds_run_as_their_data():
    _, h, _ = _fc_mean_sgd(tf)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(tf.default_startup_program())
    test = tf.default_main_program().clone(for_test=True)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    (plain,) = exe.run(test, feed={"x": x}, fetch_list=[h])
    (lod,) = exe.run(test, feed={"x": tf.LoDTensor(x, [[0, 1, 3]])},
                     fetch_list=[h])
    (tup,) = exe.run(test, feed={"x": (x, [[1, 2]])}, fetch_list=[h])
    (dev,) = exe.run(test, feed={"x": tf.LoDTensor(torch.from_numpy(x))},
                     fetch_list=[h], return_numpy=False)
    np.testing.assert_array_equal(lod, plain)
    np.testing.assert_array_equal(tup, plain)
    np.testing.assert_array_equal(np.asarray(tf.LoDTensor(dev)), plain)


def test_flag_parsing_matches_reference(monkeypatch):
    for raw in ("1", "0", "2.5", "true", "Off", "", "ON_DEMAND", True):
        got, want = port_core._flag_value(raw), ref_core._flag_value(raw)
        assert got == want and type(got) is type(want)
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    monkeypatch.setenv("FLAGS_rpc_retry_times", "3")
    for core in (port_core, ref_core):
        monkeypatch.setattr(core, "GLOBAL_FLAGS", dict(core.GLOBAL_FLAGS))
        assert core.init_gflags(["--tryfromenv=check_nan_inf,rpc_retry_times",
                                 "--benchmark=true", "ignored"])
    assert port_core.GLOBAL_FLAGS == ref_core.GLOBAL_FLAGS
    assert port_core.GLOBAL_FLAGS["check_nan_inf"] == 1
    assert port_core.GLOBAL_FLAGS["rpc_retry_times"] == 3
    assert port_core.GLOBAL_FLAGS["benchmark"] is True
    assert port_core.torch_device(port_core.CUDAPinnedPlace()) == \
        torch.device("cpu")
    assert tf.CUDAPinnedPlace is port_core.CUDAPinnedPlace


def _nan_message(fluid, fresh, core, monkeypatch, steps):
    fresh()
    _, _, loss = _fc_mean_sgd(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    monkeypatch.setitem(core.GLOBAL_FLAGS, "check_nan_inf", True)
    x = np.ones((2, 4), np.float32)
    exe.run(fluid.default_main_program(), feed={"x": x}, fetch_list=[loss])
    x[0, 1] = np.nan
    with pytest.raises(FloatingPointError) as err:
        if steps:
            exe.run_steps(fluid.default_main_program(), feed={"x": x},
                          fetch_list=[loss], n_steps=2)
        else:
            exe.run(fluid.default_main_program(), feed={"x": x},
                    fetch_list=[loss])
    return str(err.value)


@pytest.mark.parametrize("steps", [False, True], ids=["run", "run_steps"])
def test_check_nan_inf_names_the_same_variable(monkeypatch, steps):
    ref = _nan_message(rf, ref_framework.fresh_session, ref_core,
                       monkeypatch, steps)
    port = _nan_message(tf, port_framework.fresh_session, port_core,
                        monkeypatch, steps)
    assert port == ref
    assert "check_nan_inf: variable '" in port


def test_check_nan_inf_off_passes_nan_through():
    _, _, loss = _fc_mean_sgd(tf)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(tf.default_startup_program())
    x = np.full((2, 4), np.nan, np.float32)
    (val,) = exe.run(tf.default_main_program(), feed={"x": x},
                     fetch_list=[loss])
    assert np.isnan(val).all()


def _mixed(fluid):
    """A training branch off feed 'x' and a decode-like branch off feed
    'y', sharing the weight 'w'."""
    x, h, loss = _fc_mean_sgd(fluid)
    y = fluid.layers.data(name="y", shape=[4], dtype="float32")
    g = fluid.layers.fc(input=y, size=3, param_attr=fluid.ParamAttr(
        name="w"), bias_attr=False)
    return loss, h, g


def test_prune_for_unfed_matches_reference():
    out = []
    for fluid, fresh in ((rf, ref_framework.fresh_session),
                         (tf, port_framework.fresh_session)):
        fresh()
        loss, h, g = _mixed(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        main = fluid.default_main_program()
        ones = np.ones((2, 4), np.float32)
        got = [np.asarray(exe.run(main, feed={"x": ones},
                                  fetch_list=[loss])[0]),
               np.asarray(exe.run(main, feed={"y": ones},
                                  fetch_list=[g])[0])]
        w = np.asarray(fluid.global_scope().get("w"))
        out.append((got, w))
        with pytest.raises(Exception, match="y"):
            exe.run(main, feed={"x": ones}, fetch_list=[g])
    (rgot, rw), (pgot, pw) = out
    for p, r in zip(pgot, rgot):
        np.testing.assert_allclose(p, r, **TOL)
    np.testing.assert_allclose(pw, rw, **TOL)
    # the train fetch kept its optimizer (w moved once), the decode fetch
    # ran without one
    assert not np.allclose(pw, 0.5)


def test_prune_for_unfed_is_cached_per_version():
    loss, h, g = _mixed(tf)
    main = tf.default_main_program()
    scope = tf.Scope()
    feeds = {"x": torch.ones(2, 4)}
    a = _prune_for_unfed(main, feeds, [loss.name], scope)
    assert a is not main and "y" not in {
        n for op in a.global_block().ops for n in op.input_arg_names}
    assert _prune_for_unfed(main, feeds, [loss.name], scope) is a
    main.global_block().create_var(name="z", shape=(1,))
    assert _prune_for_unfed(main, feeds, [loss.name], scope) is not a
    assert _prune_for_unfed(main, {**feeds, "y": torch.ones(2, 4)},
                            [loss.name], scope) is main


def test_mnist_mlp_save_load_inference_round_trip(tmp_path):
    """``tests/test_mnist_mlp.py::test_save_load_inference_roundtrip`` on
    the port, from the reference's initial state: the loaded model in a
    fresh scope predicts what the test clone did, and what the
    reference's did."""
    out = []
    init = None
    x = np.random.RandomState(0).normal(size=(4, 784)).astype(np.float32)
    for fluid, mnist, fresh, ex in (
            (rf, ref_mnist, ref_framework.fresh_session, rf.executor),
            (tf, port_mnist, port_framework.fresh_session, tf.executor)):
        fresh()
        img, label, prediction, avg_loss, acc = mnist.mlp()
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        names = [v.name for v in fluid.default_main_program().list_vars()
                 if v.persistable]
        if init is None:
            init = {n: np.array(fluid.global_scope().get(n)) for n in names}
        else:
            for n in names:
                fluid.global_scope().get(n).copy_(torch.from_numpy(init[n]))
        test_prog = fluid.default_main_program().clone(for_test=True)
        (before,) = exe.run(test_prog, feed={"img": x},
                            fetch_list=[prediction])
        model_dir = str(tmp_path / ("ref" if fluid is rf else "port"))
        fluid.save_inference_model(model_dir, ["img"], [prediction], exe)
        ex._global_scope = ex.Scope()
        infer_prog, feed_names, fetch_vars = fluid.load_inference_model(
            model_dir, exe)
        (after,) = exe.run(infer_prog, feed={feed_names[0]: x},
                           fetch_list=fetch_vars)
        np.testing.assert_allclose(before, after, **TOL)
        out.append(np.asarray(after))
    np.testing.assert_allclose(out[1], out[0], **TOL)
