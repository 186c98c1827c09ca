"""``Executor.run_steps`` of the port, on the CPU (where the window's step
runs eagerly over its static buffers; on the card the same step is one
CUDA graph a step, ``chip_smoke.py``'s ``train_window_*`` phases).

Against the JAX package's ``run_steps``, from its initialized scope carried
into the port, on the same numpy-seeded feeds:

 - an MLP with Momentum on one feed, and on a stacked ``feed_per_step``
   feed (rtol 1e-5, atol 1e-6, as ``tests/test_run_steps.py``): the last
   loss and every persistable;
 - SGD on an ``exponential_decay`` learning rate (the step counter is
   state the window advances);
 - the tiny Transformer (dropout 0) with Adam on the noam schedule over
   4 steps: the loss within rtol 1e-4, and each persistable within 1e-4
   of its norm (not element by element: Adam moves a weight by up to
   lr = 0.022 a step whatever its grad's size, so where a grad is near
   zero its last bits move the weight by ~1e-4).

Within the port, bitwise against ``Executor.run`` step by step:

 - a guarded fp16 window (dynamic loss scale) with an overflowing step:
   every persistable, the scale and the good-step counter;
 - a window between two ``Executor.run`` calls, through a dropout (the
   generator's state and the masks);
 - a value ``scope.set`` between windows is used: copied into its buffer
   when it fits, the step built anew when its dtype changed;
 - a program with a data-dependent op raises, ``close()`` empties the
   caches, and the wrappers' launch counters move by a replay's delta.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    port_amp.disable()
    ref_amp.disable()
    yield
    port_amp.disable()
    ref_amp.disable()


def _mlp(fluid, seed=13, decay=False, dropout=0.0):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=32, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        pred = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        if decay:
            lr = fluid.layers.learning_rate_scheduler.exponential_decay(
                learning_rate=0.1, decay_steps=2, decay_rate=0.9)
            fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.normal(size=(n, 8, 16)).astype(np.float32),
            "label": rng.randint(0, 10, size=(n, 8, 1)).astype(np.int64)}


def _persistables(startup):
    return [v.name for v in startup.list_vars() if v.persistable]


def _both(build, feed, n_steps, feed_per_step):
    """``run_steps`` in both packages from the JAX package's initial
    state: ((ref loss, ref state), (port loss, port state))."""
    out, init = [], None
    for pkg in (rf, tf):
        main, startup, loss = build(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        names = _persistables(startup)
        if init is None:
            init = {n: np.array(scope.get(n)) for n in names}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        (lv,) = exe.run_steps(main, feed=feed, fetch_list=[loss],
                              n_steps=n_steps, scope=scope,
                              feed_per_step=feed_per_step)
        out.append((np.asarray(lv),
                    {n: np.array(scope.get(n)) for n in names}))
    return out


@pytest.mark.parametrize("feed_per_step", [False, True],
                         ids=["same_feed", "stacked_feed"])
def test_mlp_momentum_window_matches_reference(feed_per_step):
    fs = _feeds(4)
    feed = fs if feed_per_step else {k: v[0] for k, v in fs.items()}
    (rl, rs), (pl, ps) = _both(_mlp, feed, 4, feed_per_step)
    np.testing.assert_allclose(pl, rl, **TOL)
    assert sorted(ps) == sorted(rs)
    for k in rs:
        np.testing.assert_allclose(ps[k], rs[k], err_msg=k, **TOL)


def test_sgd_exponential_decay_window_matches_reference():
    fs = _feeds(1, seed=2)
    feed = {k: v[0] for k, v in fs.items()}
    (rl, rs), (pl, ps) = _both(lambda pkg: _mlp(pkg, seed=2, decay=True),
                               feed, 5, False)
    assert int(ps["@STEP_COUNTER@"][0]) == 5
    np.testing.assert_allclose(pl, rl, **TOL)
    for k in rs:
        np.testing.assert_allclose(ps[k], rs[k], err_msg=k, **TOL)


def _tiny_transformer(pkg):
    tm = ref_tm if pkg is rf else port_tm
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    cfg.dropout = 0.0
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=8, tgt_len=8, warmup_steps=4)
    return main, startup, cost


def test_tiny_transformer_noam_window_matches_reference():
    rng = np.random.default_rng(0)
    feed = {k: rng.integers(1, 1000, shape).astype(np.int64)
            for k, shape in (("src_word", (4, 8)), ("tgt_word", (4, 8)),
                             ("lbl_word", (4, 8, 1)))}
    (rl, rs), (pl, ps) = _both(_tiny_transformer, feed, 4, False)
    np.testing.assert_allclose(pl, rl, rtol=1e-4)
    assert int(ps["@STEP_COUNTER@"][0]) == 4
    for k in rs:
        diff = np.linalg.norm((ps[k] - rs[k]).astype(np.float64))
        assert diff <= 1e-4 * np.linalg.norm(rs[k].astype(np.float64)), k


# -- within the port ----------------------------------------------------------


def _state(scope):
    out = {}
    for k, v in scope._values.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone()
        elif isinstance(v, dict):  # the generators, by device
            out.update({f"{k}:{d}": g.get_state() for d, g in v.items()})
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _guarded_mlp():
    """An fp16 MLP with the dynamic loss scaler (scale 2^8, growth every 3
    good steps)."""
    port_amp.enable("float16", init_loss_scale=2.0 ** 8, growth_interval=3)
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 7
    with tf.program_guard(main, startup), tf.unique_name.guard():
        x = tf.layers.data(name="x", shape=[4], dtype="float32")
        y = tf.layers.data(name="y", shape=[1], dtype="float32")
        h = tf.layers.fc(input=x, size=8, act="relu")
        pred = tf.layers.fc(input=h, size=1, act=None)
        loss = tf.layers.mean(tf.layers.elementwise_mul(pred - y, pred - y))
        tf.optimizer.Momentum(learning_rate=0.05,
                              momentum=0.9).minimize(loss)
    return main, startup, loss


def test_guarded_fp16_window_bitwise_equals_per_step():
    rng = np.random.RandomState(0)
    fs = {"x": rng.normal(size=(6, 8, 4)).astype(np.float32),
          "y": rng.normal(size=(6, 8, 1)).astype(np.float32)}
    fs["x"][2] *= 1e5  # step 2 overflows in fp16: skipped, scale halves
    runs = []
    for windowed in (False, True):
        port_framework.fresh_session()
        main, startup, loss = _guarded_mlp()
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        if windowed:
            (out,) = exe.run_steps(main, feed=fs, fetch_list=[loss],
                                   n_steps=6, scope=scope, feed_per_step=True)
        else:
            scales = []
            for i in range(6):
                (out,) = exe.run(main, feed={k: v[i] for k, v in fs.items()},
                                 fetch_list=[loss], scope=scope)
                scales.append(float(scope.get("@LOSS_SCALE@")[0]))
            assert scales == [256.0, 256.0, 128.0, 128.0, 128.0, 256.0]
        runs.append((_state(scope), out))
    _assert_bitwise(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_window_between_runs_with_dropout_bitwise():
    fs = _feeds(7, seed=3)
    runs = []
    for windowed in (False, True):
        port_framework.fresh_session()
        main, startup, loss = _mlp(tf, dropout=0.3)
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        outs = []
        step = [{k: v[i] for k, v in fs.items()} for i in range(7)]
        if windowed:
            outs += [exe.run(main, feed=step[i], fetch_list=[loss],
                             scope=scope)[0] for i in range(2)]
            outs.append(exe.run_steps(
                main, feed={k: v[2:5] for k, v in fs.items()},
                fetch_list=[loss], n_steps=3, scope=scope,
                feed_per_step=True)[0])
            outs += [exe.run(main, feed=step[i], fetch_list=[loss],
                             scope=scope)[0] for i in range(5, 7)]
        else:
            outs = [exe.run(main, feed=step[i], fetch_list=[loss],
                            scope=scope)[0] for i in range(7)]
            del outs[2:4]  # the window returns only its last step's loss
        runs.append((_state(scope), outs))
    _assert_bitwise(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_scope_set_between_windows_is_honoured():
    feed = {k: v[0] for k, v in _feeds(1, seed=5).items()}
    runs = []
    for windowed in (False, True):
        port_framework.fresh_session()
        main, startup, loss = _mlp(tf, decay=True)
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        w = main.global_block().all_parameters()[0].name

        def steps(n):
            if windowed:
                return exe.run_steps(main, feed=feed, fetch_list=[loss],
                                     n_steps=n, scope=scope)
            for _ in range(n):
                out = exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)
            return out

        steps(2)
        win = next(iter(exe._windows.values())) if windowed else None
        buf = scope.get(w)
        # the same shape and dtype: copied into the window's buffer
        scope.set(w, torch.full_like(scope.get(w), 0.01))
        steps(2)
        if windowed:
            assert scope.get(w) is buf
            assert next(iter(exe._windows.values())) is win
        # the counter as int32: no longer fits, the window is built anew
        scope.set("@STEP_COUNTER@", torch.tensor([10], dtype=torch.int32))
        (out,) = steps(2)
        if windowed:
            assert next(iter(exe._windows.values())) is not win
        assert scope.get("@STEP_COUNTER@").dtype == torch.int32
        runs.append((_state(scope), out))
    _assert_bitwise(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_data_dependent_program_raises_and_lod_feed_raises():
    main, startup, loss = _mlp(tf)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    feed = {k: v[0] for k, v in _feeds(1).items()}

    class LoDFeed(np.ndarray):
        def lod(self):
            return [[0, 4, 8]]

    lod_feed = dict(feed, img=feed["img"].view(LoDFeed))
    with pytest.raises(RuntimeError, match="LoD feeds"):
        exe.run_steps(main, feed=lod_feed, fetch_list=[loss], n_steps=2,
                      scope=scope)
    block = main.global_block()
    flag = block.create_var(name="empty_flag", dtype="bool", shape=[1],
                            persistable=True)
    block.append_op(type="is_empty", inputs={"X": [loss]},
                    outputs={"Out": [flag]})
    with pytest.raises(RuntimeError, match="data-dependent"):
        exe.run_steps(main, feed=feed, fetch_list=[loss], n_steps=2,
                      scope=scope)


def test_while_body_with_beam_search_raises():
    """A data-dependent op inside a ``while`` body is found too (the
    reference's ``_op_is_eager`` looks into sub-blocks); ``Executor.run``
    runs the same program."""
    layers = tf.layers
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        pre_ids = layers.data("pre_ids", shape=[4, 1], dtype="int64",
                              append_batch_size=False)
        scores = layers.data("scores", shape=[4, 3], dtype="float32",
                             append_batch_size=False)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = layers.fill_constant(shape=[1], dtype="int64", value=2)
        cond = layers.less_than(x=i, y=n)
        loop = layers.While(cond=cond)
        with loop.block():
            layers.beam_search(pre_ids, None, None, scores, beam_size=2,
                               end_id=0)
            layers.increment(x=i, in_place=True)
            layers.less_than(x=i, y=n, cond=cond)
    feed = {"pre_ids": np.arange(4, dtype=np.int64).reshape(4, 1),
            "scores": np.random.RandomState(0).rand(4, 3).astype(
                np.float32)}
    exe = tf.Executor(tf.CPUPlace())
    assert exe.run(main, feed=feed, fetch_list=[i])[0].tolist() == [2]
    with pytest.raises(RuntimeError, match="data-dependent"):
        exe.run_steps(main, feed=feed, fetch_list=[i], n_steps=2)


def test_close_empties_the_caches():
    main, startup, loss = _mlp(tf)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    feed = {k: v[0] for k, v in _feeds(1).items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run_steps(main, feed=feed, fetch_list=[loss], n_steps=2,
                  scope=scope)
    win = next(iter(exe._windows.values()))
    assert exe._plans and exe._windows and win.bufs
    before = {k: v.clone() for k, v in scope._values.items()
              if isinstance(v, torch.Tensor)}
    exe.close()
    assert not exe._plans and not exe._windows and not win.bufs
    assert win.graph.graph is None
    # the scope keeps the state, and the next window builds afresh
    for k, v in before.items():
        assert torch.equal(scope.get(k), v), k
    exe.run_steps(main, feed=feed, fetch_list=[loss], n_steps=1,
                  scope=scope)
    assert len(exe._windows) == 1


def test_feed_per_step_needs_n_steps_slices():
    main, startup, loss = _mlp(tf)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="n_steps"):
        exe.run_steps(main, feed=_feeds(3), fetch_list=[loss], n_steps=4,
                      scope=scope, feed_per_step=True)


def test_launch_counts_add_a_replays_delta():
    from paddle_tpu_torch.ops import fused, launch_counts

    before = launch_counts.snapshot()
    assert ("fused", "adam_launches", None) in before
    assert ("flash_attention", "flash_fwd_launches_by_dtype",
            "bfloat16") in before
    fused.adam_launches += 1
    fused.xent_fwd_launches_by_dtype["bfloat16"] += 2
    change = launch_counts.delta(before, launch_counts.snapshot())
    assert change == {("fused", "adam_launches", None): 1,
                      ("fused", "xent_fwd_launches_by_dtype",
                       "bfloat16"): 2}
    launch_counts.add(change, 3)
    launch_counts.add(change, -4)
    assert launch_counts.snapshot() == before
