"""The book's RNN encoder-decoder (the reference's ``tests/test_book.py:445``
``test_rnn_encoder_decoder``: a bi-LSTM encoder, a ``DynamicRNN`` LSTM-step
decoder with a ``static_input`` context and a ``need_reorder`` memory) in
the port against the JAX package, on the CPU: the same Program from the
same calls; from the reference's initialized scope, 5 Adam steps on the
test's padded wmt16 batches (8 x 10 words) and one on a ragged batch,
losses within rtol 1e-5 at step 0 and 1e-4 after; then the test clone's
prediction, and the same through ``save_inference_model`` /
``load_inference_model`` in a fresh scope, within rtol 1e-5 of the
reference's."""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.dataset import wmt16
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

DICT, EMB, HID, SL, TL, BATCH, STEPS = 33, 16, 32, 10, 10, 8, 5


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def build(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 8
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src_word", shape=[1], dtype="int64",
                          lod_level=1)
        src_emb = layers.embedding(input=src, size=[DICT, EMB])
        fwd_proj = layers.fc(input=src_emb, size=HID * 4, bias_attr=False)
        fwd, _ = layers.dynamic_lstm(input=fwd_proj, size=HID * 4)
        bwd_proj = layers.fc(input=src_emb, size=HID * 4, bias_attr=False)
        bwd, _ = layers.dynamic_lstm(input=bwd_proj, size=HID * 4,
                                     is_reverse=True)
        context = layers.concat([layers.sequence_last_step(fwd),
                                 layers.sequence_first_step(bwd)], axis=1)
        boot = layers.fc(input=context, size=HID, act="tanh")
        trg = layers.data(name="trg_word", shape=[1], dtype="int64",
                          lod_level=1)
        trg_emb = layers.embedding(input=trg, size=[DICT, EMB])
        rnn = layers.DynamicRNN()
        with rnn.block():
            x = rnn.step_input(trg_emb)
            ctx = rnn.static_input(context)
            h_mem = rnn.memory(init=boot, need_reorder=True)
            c_mem = rnn.memory(shape=[HID], value=0.0)
            gates = layers.fc(input=[x, ctx, h_mem], size=HID * 4)
            i, f, o, ch = layers.split(gates, num_or_sections=4, dim=1)
            c_new = layers.elementwise_add(
                layers.elementwise_mul(layers.sigmoid(f), c_mem),
                layers.elementwise_mul(layers.sigmoid(i), layers.tanh(ch)))
            h_new = layers.elementwise_mul(layers.sigmoid(o),
                                           layers.tanh(c_new))
            rnn.update_memory(h_mem, h_new)
            rnn.update_memory(c_mem, c_new)
            rnn.output(layers.fc(input=h_new, size=DICT, act="softmax"))
        prediction = rnn()
        lbl = layers.data(name="lbl_word", shape=[1], dtype="int64",
                          lod_level=1)
        loss = layers.mean(layers.cross_entropy(input=prediction, label=lbl))
        fluid.optimizer.Adam(learning_rate=8e-3).minimize(loss)
    return main, startup, loss, prediction


def batches():
    """The test's first ``STEPS`` padded batches (one length a role), then
    one ragged batch cut from the next sentences."""
    def pad(ids, n):
        return (list(ids) + [1] * n)[:n]

    rows = []
    for s, t, tn in wmt16.train(DICT, DICT)():
        rows.append((s, t, tn))
        if len(rows) == BATCH * (STEPS + 1):
            break
    out = []
    for k in range(STEPS + 1):
        chunk = rows[k * BATCH:(k + 1) * BATCH]
        if k < STEPS:
            lens = [(SL, TL)] * BATCH
        else:
            rng = np.random.RandomState(3)
            lens = [(int(a), int(b)) for a, b in
                    zip(rng.randint(1, SL + 1, BATCH),
                        rng.randint(1, TL + 1, BATCH))]
        out.append([(pad(s, ls), pad(t, lt), pad(tn, lt))
                    for (s, t, tn), (ls, lt) in zip(chunk, lens)])
    return out


def feed(fluid, batch):
    def lod(k):
        seqs = [b[k] for b in batch]
        return fluid.create_lod_tensor(
            np.array(sum(seqs, []), np.int64).reshape(-1, 1),
            [[len(s) for s in seqs]])

    return {"src_word": lod(0), "trg_word": lod(1), "lbl_word": lod(2)}


def _run(fluid, init, tmp):
    main, startup, loss, prediction = build(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.executor.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.asarray(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    losses = []
    data = batches()
    for batch in data:
        (val,) = exe.run(main, feed=feed(fluid, batch), fetch_list=[loss],
                         scope=scope)
        losses.append(float(np.asarray(val).reshape(-1)[0]))
    test = main.clone(for_test=True)
    infer_feed = {k: v for k, v in feed(fluid, data[0]).items()
                  if k != "lbl_word"}
    (pred,) = exe.run(test, feed=infer_feed, fetch_list=[prediction],
                      scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp), ["src_word", "trg_word"],
                                      [prediction], exe, main_program=main)
    exe2, scope2 = fluid.Executor(fluid.CPUPlace()), fluid.executor.Scope()
    with fluid.scope_guard(scope2):
        prog, feeds, fetches = fluid.io.load_inference_model(str(tmp), exe2)
        assert feeds == ["src_word", "trg_word"]
        (loaded,) = exe2.run(prog, feed=infer_feed, fetch_list=fetches)
    return init, np.array(losses), np.asarray(pred), np.asarray(loaded), main


def test_rnn_encoder_decoder_matches_reference(tmp_path):
    init, r_losses, r_pred, r_loaded, rmain = _run(rf, None, tmp_path / "r")
    _, p_losses, p_pred, p_loaded, pmain = _run(tf, init, tmp_path / "p")
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in rmain.global_block().ops]
    assert [[op.type for op in b.ops] for b in pmain.blocks] == \
        [[op.type for op in b.ops] for b in rmain.blocks]
    assert np.all(np.isfinite(p_losses))
    rtol = np.array([1e-5] + [1e-4] * STEPS)
    assert np.all(np.abs(p_losses - r_losses) <= rtol * np.abs(r_losses)), \
        (p_losses, r_losses)
    np.testing.assert_allclose(p_pred, r_pred, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(p_loaded, p_pred)
    np.testing.assert_allclose(p_loaded, r_loaded, rtol=1e-5, atol=1e-7)
