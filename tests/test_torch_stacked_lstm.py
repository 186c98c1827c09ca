"""``fluid_benchmark.py``'s stacked dynamic LSTM (``models/stacked_lstm.py``)
and ``nets.sequence_conv_pool`` in the port against the JAX package, on
the CPU:

 - ``stacked_lstm.build`` gives the reference's Program: the same op
   types in order and the same parameters (names and shapes), at the
   full width (``dict_dim=5147, emb_dim=hid_dim=512, stacked_num=3``:
   70 ops, 18 parameters, 3,754,882 values) and at the small config of
   the reference's ``tests/test_benchmark_models.py:31``;
 - at that small config, from the reference's initial scope
   (``load_reference_params``), 6 Adam steps on a LoD batch (``[[6,
   7]]``, as that test feeds) and on a ragged one (lengths 5, 1, 7, 3):
   the losses within rtol 1e-5 at step 0 and 1e-4 after;
 - ``nets.sequence_conv_pool`` trains the text-CNN of the reference's
   ``tests/test_book.py:414`` for its 25 Adam steps on the same batches
   in both packages, within the same tolerances, and its loss falls (the
   last 5 steps' mean under the first 5's, as that test holds it).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import stacked_lstm as ref_sl
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import stacked_lstm as port_sl
from paddle_tpu_torch.models.params import load_reference_params

FULL = dict(dict_dim=5147, emb_dim=512, hid_dim=512, stacked_num=3,
            lr=1e-3)
SMALL = dict(dict_dim=80, emb_dim=24, hid_dim=24, stacked_num=2, lr=1e-2)
STEPS = 6
LOSS_RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _build(pkg, model, cfg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss, acc = model.build(**cfg)
    return main, startup, loss


def _params(main):
    return [(p.name, tuple(p.shape))
            for p in main.global_block().all_parameters()]


@pytest.mark.parametrize("cfg", [FULL, SMALL], ids=["full", "small"])
def test_same_program(cfg):
    rmain, rstart, rloss = _build(rf, ref_sl, cfg)
    pmain, pstart, ploss = _build(tf, port_sl, cfg)
    types = [op.type for op in pmain.global_block().ops]
    assert types == [op.type for op in rmain.global_block().ops]
    assert [op.type for op in pstart.global_block().ops] == \
        [op.type for op in rstart.global_block().ops]
    assert _params(pmain) == _params(rmain)
    assert ploss.name == rloss.name
    if cfg is FULL:
        assert len(types) == 70
        assert len(_params(pmain)) == 18
        assert sum(int(np.prod(s)) for _, s in _params(pmain)) == 3754882
        fwd = types[:types.index("mean") + 1] + ["top_k", "accuracy"]
        assert sorted(set(fwd)) == sorted(
            ["lookup_table", "mul", "sum", "elementwise_add", "dynamic_lstm",
             "sequence_pool", "softmax", "cross_entropy", "mean", "top_k",
             "accuracy"])
        assert types.count("dynamic_lstm") == 3 and types.count("adam") == 18


def _trajectory(pkg, model, cfg, feeds, init=None):
    main, startup, loss = _build(pkg, model, cfg)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=f(pkg), fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return np.array(losses), init


def _lstm_feed(lens, seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, SMALL["dict_dim"], size=(sum(lens), 1)).astype(
        np.int64)
    label = rng.randint(0, 2, size=(len(lens), 1)).astype(np.int64)

    def make(pkg):
        return {"words": pkg.create_lod_tensor(words, [lens], pkg.CPUPlace()),
                "label": label}
    return make


@pytest.mark.parametrize("lens", [[6, 7], [5, 1, 7, 3]],
                         ids=["reference_batch", "ragged"])
def test_small_trajectory_matches_reference(lens):
    feeds = [_lstm_feed(lens, 0)] * STEPS
    ref, init = _trajectory(rf, ref_sl, SMALL, feeds)
    port, _ = _trajectory(tf, port_sl, SMALL, feeds, init)
    np.testing.assert_array_less(np.abs(port - ref) / np.abs(ref), LOSS_RTOL)
    assert port[-1] < port[0]


def _text_cnn(pkg):
    def build(**_):
        words = pkg.layers.data(name="words", shape=[1], dtype="int64",
                                lod_level=1)
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        emb = pkg.layers.embedding(input=words, size=[30, 8])
        feat = pkg.nets.sequence_conv_pool(emb, num_filters=4,
                                           filter_size=3, act="tanh")
        pred = pkg.layers.fc(input=feat, size=2, act="softmax")
        loss = pkg.layers.mean(
            pkg.layers.cross_entropy(input=pred, label=label))
        pkg.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return words, label, pred, loss, None
    return build


class _Model:
    def __init__(self, pkg):
        self.build = _text_cnn(pkg)


def _cnn_feeds(n):
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(n):
        ys = rng.randint(0, 2, size=(4, 1)).astype(np.int64)
        lens = [4, 5, 3, 6]
        toks = np.concatenate([
            rng.randint(15 if ys[i, 0] else 0, 30 if ys[i, 0] else 15,
                        size=(lens[i], 1)) for i in range(4)]).astype(
            np.int64)
        feeds.append(lambda pkg, t=toks, y=ys, ln=lens:
                     {"words": (t, [ln]), "label": y})
    return feeds


def test_sequence_conv_pool_trains_as_reference():
    feeds = _cnn_feeds(25)
    ref, init = _trajectory(rf, _Model(rf), {}, feeds)
    port, _ = _trajectory(tf, _Model(tf), {}, feeds, init)
    tol = np.array([1e-5] + [1e-4] * (len(feeds) - 1))
    np.testing.assert_array_less(np.abs(port - ref) / np.abs(ref), tol)
    assert np.mean(port[-5:]) < np.mean(port[:5])
