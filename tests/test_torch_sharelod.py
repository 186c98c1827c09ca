"""The port's ShareLoD rule never gives a LoD to a parameter or to the
grad of a persistable (``paddle_tpu_torch/fluid/executor.py``
``_store``).

The case: the stacked LSTM at ``dict_dim=80, emb_dim=32, hid_dim=32,
stacked_num=2`` (Adam 1e-2) on one batch of 4 x 8 words, then a batch of
lengths [5, 9, 7, 3].  ``fc_0.w_0`` is [32, 32]: under the reference's rule
its grad takes the first batch's 32-row LoD, the optimizer keeps it on the
parameter, and the second batch's ``dynamic_lstm`` then finds two LoDs
and raises.  In the port both steps run; the second step's loss equals the
reference's on that batch, run from a fresh reference scope that holds the
port's state after step 1 (parameters, Adam moments and beta powers), and
no parameter keeps a LoD in the scope.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import stacked_lstm as ref_sl
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import stacked_lstm as port_sl

CFG = dict(dict_dim=80, emb_dim=32, hid_dim=32, stacked_num=2, lr=1e-2)
LENS = ([8] * 4, [5, 9, 7, 3])


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _build(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = model.build(**CFG)[3]
    return main, startup, loss


def _feeds(pkg):
    rng = np.random.RandomState(0)
    feeds = []
    for lens in LENS:
        words = rng.randint(0, CFG["dict_dim"],
                            (sum(lens), 1)).astype(np.int64)
        feeds.append({"words": pkg.create_lod_tensor(words, [lens]),
                      "label": rng.randint(0, 2, (4, 1)).astype(np.int64)})
    return feeds


def _port_two_steps():
    main, startup, loss = _build(tf, port_sl)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    losses, states = [], []
    for feed in _feeds(tf):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
        states.append({v.name: scope.get(v.name).detach().numpy().copy()
                       for v in main.list_vars() if v.persistable
                       and scope.get(v.name) is not None})
    return main, scope, losses, states


def test_ragged_batch_after_fixed_trains_as_reference():
    _, _, losses, states = _port_two_steps()
    assert all(np.isfinite(losses))
    rmain, rstart, rloss = _build(rf, ref_sl)
    rexe, rscope = rf.Executor(rf.CPUPlace()), rf.executor.Scope()
    rexe.run(rstart, scope=rscope)
    after_one = states[0]
    names = [v.name for v in rmain.list_vars() if v.persistable
             and rscope.get(v.name) is not None]
    assert sorted(names) == sorted(after_one)
    for name in names:
        rscope.set(name, after_one[name])
    (want,) = rexe.run(rmain, feed=_feeds(rf)[1], fetch_list=[rloss],
                       scope=rscope)
    np.testing.assert_allclose(losses[1], np.asarray(want).reshape(-1)[0],
                               rtol=1e-5)


def test_parameter_keeps_no_lod():
    main, scope, _, _ = _port_two_steps()
    params = [p.name for p in main.global_block().all_parameters()]
    assert "fc_0.w_0" in params
    assert not {n: scope._lods[n] for n in params if n in scope._lods}
    assert not scope._lods
