"""DeepFM (``models/deepfm.py``) in the port against the JAX package, on the
CPU, at a small size (26 fields, a 300-id vocabulary, k = 4, a 16 / 8
deep tower, batch 16):

 - ``deepfm.build`` gives the same startup and main Programs in both
   packages, sparse and dense (exact: the IR is data);
 - from the JAX package's initial scope, carried across with
   ``load_reference_params`` (the 1-column ``fm_w1`` table among it), 4
   SGD steps on numpy-seeded ids with repeats: the losses at rtol 1e-5 at
   step 0 and 1e-4 after, and both tables after the last step at rtol
   1e-5 / atol 1e-6; every table row no step looked up keeps its bits;
 - the sparse and the dense build of the port train alike (the sparse
   update is the dense one restricted to the looked-up rows);
 - under bf16 AMP with kept activations (the deep tower's products in
   bf16, the tables, their SelectedRows grads and the loss fp32), 3 steps
   against the reference jitted without XLA's excess precision (so it
   rounds where its source says, ``tests/test_torch_amp_train.py``): the
   loss at rtol 1e-5 at step 0 and 1e-3 after, a quarter of bf16's
   relative step, as that file holds the tiny Transformer (measured 8.6e-8,
   3.9e-5, 3.8e-5).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import deepfm as ref_dfm
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import deepfm as port_dfm
from paddle_tpu_torch.models.params import load_reference_params

FIELDS, VOCAB, K, DEEP, BATCH, STEPS = 26, 300, 4, (16, 8), 16, 4
LOSS_RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))
STATE_TOL = dict(rtol=1e-5, atol=1e-6)


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
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _build(pkg, model, is_sparse=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = model.build(num_fields=FIELDS, vocab_size=VOCAB,
                                    embed_dim=K, deep_layers=DEEP, lr=0.5,
                                    is_sparse=is_sparse)
    return main, startup, cost


def _feeds():
    """STEPS batches of ids drawn from the lower half of the vocabulary
    (the upper half is never looked up), each with a repeated id."""
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(STEPS):
        feats = rng.randint(0, VOCAB // 2, (BATCH, FIELDS)).astype(np.int64)
        feats[:, 0] = feats[0, 1]
        feeds.append({"feats": feats, "label": rng.randint(
            0, 2, (BATCH, 1)).astype(np.float32)})
    return feeds


@pytest.mark.parametrize("is_sparse", [True, False], ids=["sparse", "dense"])
def test_same_program(is_sparse):
    rmain, rstart, rcost = _build(rf, ref_dfm, is_sparse)
    pmain, pstart, pcost = _build(tf, port_dfm, is_sparse)
    assert pcost.name == rcost.name
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    lookups = [op for op in pmain.global_block().ops
               if op.type == "lookup_table"]
    assert [op.attr("is_sparse") for op in lookups] == [is_sparse] * 2


def _train(pkg, model, init=None, is_sparse=True, steps=STEPS):
    main, startup, cost = _build(pkg, model, is_sparse)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    if init is None:
        init = {n: np.array(scope.get(n)) for n in names}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[cost],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in _feeds()[:steps]]
    return np.array(losses), {n: np.array(scope.get(n)) for n in names}, \
        init


def test_training_matches_reference():
    ref_losses, ref_state, init = _train(rf, ref_dfm)
    assert init["fm_w1"].shape == (VOCAB, 1)
    port_losses, port_state, _ = _train(tf, port_dfm, init)
    rel = np.abs(port_losses - ref_losses) / np.abs(ref_losses)
    assert (rel <= LOSS_RTOL).all(), (port_losses, ref_losses, rel)
    assert port_losses[-1] < port_losses[0]
    for name in ref_state:
        np.testing.assert_allclose(port_state[name], ref_state[name],
                                   err_msg=name, **STATE_TOL)
    for table in ("fm_w1", "fm_v"):
        untouched = port_state[table][VOCAB // 2:]
        np.testing.assert_array_equal(untouched, init[table][VOCAB // 2:])
        assert not np.array_equal(port_state[table][:VOCAB // 2],
                                  init[table][:VOCAB // 2])


def test_sparse_trains_as_dense():
    sparse_losses, sparse_state, init = _train(tf, port_dfm)
    port_framework.fresh_session()
    dense_losses, dense_state, _ = _train(tf, port_dfm, init,
                                          is_sparse=False)
    np.testing.assert_allclose(sparse_losses, dense_losses, rtol=1e-5)
    for name in sparse_state:
        np.testing.assert_allclose(sparse_state[name], dense_state[name],
                                   err_msg=name, **STATE_TOL)


def test_sparse_grad_is_selected_rows():
    """``fm_v@GRAD`` and ``fm_w1@GRAD`` are SelectedRows of one row an
    occurrence; the SGD step has no dense ``[V, k]`` grad."""
    from paddle_tpu_torch.fluid.selected_rows import SelectedRows

    main, startup, cost = _build(tf, port_dfm)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds()[0]
    _, gv, gw = exe.run(main, feed=feed,
                        fetch_list=[cost, "fm_v@GRAD", "fm_w1@GRAD"],
                        scope=scope)
    for g, width in ((gv.item(), K), (gw.item(), 1)):
        assert isinstance(g, SelectedRows)
        assert tuple(g.values.shape) == (BATCH * FIELDS, width)
        assert torch.equal(g.rows, torch.from_numpy(feed["feats"].ravel()))
        assert g.shape == (VOCAB, width)


@pytest.fixture
def bf16_keep_strict_reference(monkeypatch):
    """bf16 AMP with kept activations in both packages, and ``jax.jit``
    without XLA's excess precision."""
    jit = jax.jit

    def strict_jit(fun=None, **kw):
        kw.setdefault("compiler_options",
                      {"xla_allow_excess_precision": False})
        if fun is None:
            return functools.partial(strict_jit, **kw)
        return jit(fun, **kw)

    monkeypatch.setattr(jax, "jit", strict_jit)
    saved = dict(ref_amp._state), dict(port_amp._state)
    for amp in (ref_amp, port_amp):
        amp.enable("bfloat16", keep_activations=True)
    yield
    for amp, state in zip((ref_amp, port_amp), saved):
        amp._state.update(state)
        amp.disable()


def test_bf16_keep_matches_reference(bf16_keep_strict_reference):
    steps = 3
    ref_losses, ref_state, init = _train(rf, ref_dfm, steps=steps)
    port_losses, port_state, _ = _train(tf, port_dfm, init, steps=steps)
    rel = np.abs(port_losses - ref_losses) / np.abs(ref_losses)
    assert (rel <= np.array([1e-5, 1e-3, 1e-3])).all(), (port_losses,
                                                          ref_losses, rel)
    main, startup, cost = _build(tf, port_dfm)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    _, gv = exe.run(main, feed=_feeds()[0], fetch_list=[cost, "fm_v@GRAD"],
                    scope=scope)
    assert gv.item().values.dtype == torch.float32
    assert scope.get("fm_v").dtype == torch.float32
