"""The port's ``DevicePrefetcher`` (``paddle_tpu_torch/fluid/prefetch.py``)
held to the reference's contract (``tests/test_prefetch.py``), on the CPU:
windows stack along a leading dim with a short tail and equal the JAX
package's windows value for value; a worker's exception reaches the
consumer; an early exit does not wedge; ``depth=0`` stages in the caller's
thread; ``PADDLE_TPU_PREFETCH_DEPTH`` sets the default depth; sample-level
staging (``iter_device_samples``) keeps order and raises a reader's error;
a prefetched ``feed_per_step`` loop trains exactly as one stacked window;
with no place the prefetcher wants the card.  (On the card, staging goes
through pinned memory and a side stream: ``chip_smoke.py``'s
``train_window_resnet_amp``.)"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid.prefetch import DevicePrefetcher as RefPrefetcher
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid.prefetch import (DevicePrefetcher, default_depth,
                                             iter_device_samples)


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _feeds(n, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield {"x": rng.normal(size=(8, dim)).astype(np.float32),
               "y": rng.normal(size=(8, 1)).astype(np.float32)}


def test_windows_stack_and_tail_as_the_reference():
    got = list(DevicePrefetcher(_feeds(10), n_steps=4, place=tf.CPUPlace(),
                                depth=2))
    ref = list(RefPrefetcher(_feeds(10), n_steps=4, place=rf.CPUPlace(),
                             depth=2))
    assert [count for _, count in got] == [4, 4, 2]
    assert [count for _, count in ref] == [4, 4, 2]
    for (feed, count), (rfeed, _) in zip(got, ref):
        assert set(feed) == {"x", "y"}
        assert isinstance(feed["x"], torch.Tensor)
        assert feed["x"].shape == (count, 8, 4)
        for name in feed:
            np.testing.assert_array_equal(feed[name].numpy(),
                                          np.asarray(rfeed[name]))
    steps = list(_feeds(10))
    np.testing.assert_array_equal(got[2][0]["y"][1].numpy(), steps[9]["y"])


def test_staged_windows_are_copies():
    src = list(_feeds(2))
    (feed, _), = list(DevicePrefetcher(iter(src), n_steps=2,
                                       place=tf.CPUPlace(), depth=0))
    feed["x"][0] += 1.0
    np.testing.assert_array_equal(src[0]["x"], list(_feeds(1))[0]["x"])


def test_worker_exception_propagates_to_consumer():
    class Boom(RuntimeError):
        pass

    def bad_feeds():
        yield from _feeds(3)
        raise Boom("reader died")

    pf = DevicePrefetcher(bad_feeds(), n_steps=2, place=tf.CPUPlace(),
                          depth=2)
    with pytest.raises(Boom, match="reader died"):
        for _ in pf:
            pass


def test_early_exit_does_not_wedge():
    pf = DevicePrefetcher(_feeds(64), n_steps=2, place=tf.CPUPlace(),
                          depth=2)
    for _ in pf:
        break
    pf.close()
    t0 = time.time()
    assert list(pf) == []
    assert time.time() - t0 < 5.0
    deadline = time.time() + 5.0
    while any(t.name == "device-prefetch" for t in threading.enumerate()):
        assert time.time() < deadline, "the staging thread did not stop"
        time.sleep(0.01)


def test_depth_zero_is_synchronous():
    seen = []

    def feeds():
        for f in _feeds(4):
            seen.append(threading.current_thread().name)
            yield f

    got = list(DevicePrefetcher(feeds(), n_steps=2, place=tf.CPUPlace(),
                                depth=0))
    assert [count for _, count in got] == [2, 2]
    assert set(seen) == {threading.current_thread().name}


def test_default_depth_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PREFETCH_DEPTH", "5")
    assert default_depth() == 5
    assert DevicePrefetcher(_feeds(1), place=tf.CPUPlace()).depth == 5
    monkeypatch.setenv("PADDLE_TPU_PREFETCH_DEPTH", "")
    assert default_depth() == 2
    from paddle_tpu_torch.fluid import envcontract

    knob = envcontract.REGISTRY["PADDLE_TPU_PREFETCH_DEPTH"]
    assert (knob.type, knob.default) == ("int", 2)


def test_iter_device_samples_order_and_errors():
    def reader():
        for i in range(6):
            yield (np.full((3,), i, np.float32), i)

    out = list(iter_device_samples(reader, depth=2, place=tf.CPUPlace()))
    assert len(out) == 6
    for i, (arr, tag) in enumerate(out):
        assert isinstance(arr, torch.Tensor) and tag == i
        np.testing.assert_array_equal(arr.numpy(), np.full((3,), i))

    def bad_reader():
        yield (np.zeros((3,), np.float32), 0)
        raise ValueError("decode failed")

    with pytest.raises(ValueError, match="decode failed"):
        list(iter_device_samples(bad_reader, depth=2, place=tf.CPUPlace()))


def test_no_place_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(Exception):
        list(DevicePrefetcher(_feeds(2), n_steps=2, depth=0))


def _train_program():
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data(name="x", shape=[4], dtype="float32")
        y = tf.layers.data(name="y", shape=[1], dtype="float32")
        h = tf.layers.fc(input=x, size=8, act="relu")
        pred = tf.layers.fc(input=h, size=1, act=None)
        loss = tf.layers.mean(tf.layers.elementwise_mul(pred - y, pred - y))
        tf.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def test_prefetched_windows_train_as_one_stacked_window():
    main, startup, loss = _train_program()
    states = []
    for prefetched in (True, False):
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        if prefetched:
            with DevicePrefetcher(_feeds(10), n_steps=4, place=tf.CPUPlace(),
                                  depth=2) as pf:
                for feed, count in pf:
                    (out,) = exe.run_steps(main, feed=feed,
                                           fetch_list=[loss], n_steps=count,
                                           scope=scope, feed_per_step=True)
        else:
            steps = list(_feeds(10))
            stacked = {k: np.stack([s[k] for s in steps]) for k in steps[0]}
            (out,) = exe.run_steps(main, feed=stacked, fetch_list=[loss],
                                   n_steps=10, scope=scope,
                                   feed_per_step=True)
        states.append(({k: v.clone() for k, v in scope._values.items()
                        if isinstance(v, torch.Tensor)}, out))
    (a, la), (b, lb) = states
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(la, lb)
