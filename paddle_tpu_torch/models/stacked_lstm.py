"""Stacked dynamic-LSTM sentiment classifier (counterpart of
``paddle_tpu/models/stacked_lstm.py``; ``benchmark/fluid/
stacked_dynamic_lstm.py``): embedding -> N x (fc + dynamic LSTM) ->
sequence max-pool over both towers -> softmax.

The input is a LoDTensor of word ids; the offsets are host metadata of
each run, so one Program serves every batch's lengths.
"""

from __future__ import annotations

from .. import fluid


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=512,
                     hid_dim=512, stacked_num=3, is_sparse=False):
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim],
                                 is_sparse=is_sparse)
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, _ = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, _ = fluid.layers.dynamic_lstm(input=fc, size=hid_dim,
                                            is_reverse=False)
        inputs = [fc, lstm]

    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    return fluid.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")


def build(dict_dim=5147, class_dim=2, emb_dim=512, hid_dim=512,
          stacked_num=3, lr=None):
    """data: LoDTensor of int64 word ids [sum_len, 1]; label: [batch, 1]."""
    data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    prediction = stacked_lstm_net(data, dict_dim, class_dim=class_dim,
                                  emb_dim=emb_dim, hid_dim=hid_dim,
                                  stacked_num=stacked_num)
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    if lr is not None:
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return data, label, prediction, loss, acc
