"""BERT pretraining (``models/bert.py``) in the port against the JAX package,
on the CPU:

 - ``bert.build`` gives the same startup and main Programs in both
   packages for BERT-base at length 128 and for ``tiny_config``, with the
   attention unfused and through the ``ring_attention`` op (exact: the IR
   is data); ``synthetic_batch`` gives the same batch from the same seed;
 - ``tiny_config`` (2 layers, d_model 64, 4 heads, vocab 500, dropout 0)
   at batch 2 x 32 with 4 masked positions a row and padded keys in one
   row, from the JAX package's initial scope carried across with
   ``load_reference_params`` (word, position and type tables among it): 4
   Adam steps, flash off and on (on the CPU the flash op runs its plain
   version, the reference its Pallas kernels in interpret mode); the total
   loss at rtol 1e-5 at step 0 and 1e-4 after, and the MLM and NSP losses
   of the last step the same;
 - the same 3 steps in bf16 with kept activations, against the
   reference jitted without XLA's excess precision (it then rounds where
   its source says, ``tests/test_torch_amp_train.py``).  Unfused: the
   total loss at rtol 1e-5 at step 0 (measured: bitwise) and 1e-3 after,
   as that file holds the tiny Transformer.  Flash: the port's bf16 plain
   versions and the reference's Pallas kernels round an output to bf16 a
   ulp apart here and there (``tests/test_torch_flash_amp.py``), and the
   MLM loss is the log of bf16-rounded probabilities, so a one-ulp flip in
   a logit moves the mean loss by ~3e-4 (measured 3.0e-4 at step 0, 6.0e-4
   at step 2): within bf16's relative step 2^-8, the card-against-CPU
   bound of ``chip_smoke.AMP_PARITY_RTOL``;
 - ``stacked=True`` raises ``NotImplementedError``.
"""

import functools

import jax
import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import bert as ref_bert
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models.params import load_reference_params

BATCH, SEQ, N_MASK, STEPS = 2, 32, 4, 4
LOSS_RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))


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
    if isinstance(v, np.ndarray):
        return v.tolist()
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


def _build(pkg, model, config, flash, seq_len=SEQ, n_mask=N_MASK):
    cfg = getattr(model, config)()
    cfg.flash_attention = flash
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        outs = model.build(cfg, seq_len=seq_len, n_mask=n_mask, lr=1e-3)
    return main, startup, outs


@pytest.mark.parametrize("config,flash", [("base_config", True),
                                          ("tiny_config", False),
                                          ("tiny_config", True)])
def test_same_program(config, flash):
    seq = 128 if config == "base_config" else SEQ
    rmain, rstart, routs = _build(rf, ref_bert, config, flash, seq, 20)
    pmain, pstart, pouts = _build(tf, port_bert, config, flash, seq, 20)
    assert [v.name for v in pouts] == [v.name for v in routs]
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    types = [op.type for op in pmain.global_block().ops]
    n_layer = 12 if config == "base_config" else 2
    assert types.count("ring_attention") == (n_layer if flash else 0)
    assert {"gather", "slice", "tanh", "gather_grad", "slice_grad"} <= \
        set(types)


def test_synthetic_batch_matches_reference():
    cfg = port_bert.tiny_config()
    got = port_bert.synthetic_batch(cfg, 3, SEQ, N_MASK,
                                    np.random.RandomState(7))
    want = ref_bert.synthetic_batch(ref_bert.tiny_config(), 3, SEQ, N_MASK,
                                    np.random.RandomState(7))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _feed():
    feed = ref_bert.synthetic_batch(ref_bert.tiny_config(), BATCH, SEQ,
                                    N_MASK, np.random.RandomState(0))
    feed["src_ids"][1, -5:] = 0  # padded keys: the bias path
    return feed


def _train(pkg, model, flash, init=None, steps=STEPS):
    main, startup, outs = _build(pkg, model, "tiny_config", flash)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    total, mlm, nsp = outs[5:8]
    fetched = [[float(np.asarray(x).reshape(-1)[0]) for x in
                exe.run(main, feed=_feed(), fetch_list=[total, mlm, nsp],
                        scope=scope)]
               for _ in range(steps)]
    return np.array(fetched), init


@pytest.mark.parametrize("flash", [False, True], ids=["unfused", "flash"])
def test_training_matches_reference(flash):
    ref, init = _train(rf, ref_bert, flash)
    for name in ("bert_word_emb", "bert_pos_emb", "bert_type_emb"):
        assert name in init
    port, _ = _train(tf, port_bert, flash, init)
    rel = np.abs(port - ref) / np.abs(ref)
    assert (rel[:, 0] <= LOSS_RTOL).all(), (port[:, 0], ref[:, 0], rel)
    assert (rel[-1] <= LOSS_RTOL[-1]).all(), (port[-1], ref[-1])
    assert port[-1, 0] < port[0, 0]


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


@pytest.mark.parametrize("flash", [False, True], ids=["unfused", "flash"])
def test_bf16_keep_matches_reference(flash, bf16_keep_strict_reference):
    ref, init = _train(rf, ref_bert, flash, steps=3)
    port, _ = _train(tf, port_bert, flash, init, steps=3)
    rel = np.abs(port[:, 0] - ref[:, 0]) / np.abs(ref[:, 0])
    rtol = np.full(3, 2.0 ** -8) if flash else np.array([1e-5, 1e-3, 1e-3])
    assert (rel <= rtol).all(), (port[:, 0], ref[:, 0], rel)


def test_stacked_is_not_ported():
    cfg = port_bert.tiny_config()
    cfg.stacked = True
    with tf.program_guard(tf.Program(), tf.Program()):
        with pytest.raises(NotImplementedError, match="item 12"):
            port_bert.build(cfg, seq_len=SEQ, n_mask=N_MASK)
