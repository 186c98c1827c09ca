"""DeepFM CTR model over sparse categorical features (counterpart of
``paddle_tpu/models/deepfm.py``, built call for call).

Every categorical field is an int64 id into one shared hashed vocabulary.
Three towers share the embeddings: a ``[V, 1]`` first-order table summed
over fields, the FM second-order term
``0.5 · Σ_k((Σ_f v_f)² − Σ_f v_f²)`` over a ``[V, k]`` table, and an MLP
over the concatenated field embeddings.  With ``is_sparse=True`` (the default) both tables' grads are
SelectedRows, so the SGD step touches only the looked-up rows.
"""

from __future__ import annotations

from .. import fluid


def build(num_fields=26, vocab_size=10000, embed_dim=8,
          deep_layers=(64, 32), lr=None, is_sparse=True):
    """Returns (feats, label, predict, avg_cost).

    feats: int64 [batch, num_fields] hashed ids; label: float32 [batch, 1].
    Pass ``lr`` to attach a (sparse-capable) SGD optimizer.
    """
    feats = fluid.layers.data(name="feats", shape=[num_fields], dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="float32")

    # first-order term: [B, F, 1] -> sum over fields -> [B, 1]
    w1 = fluid.layers.embedding(
        input=feats, size=[vocab_size, 1], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name="fm_w1"))
    first = fluid.layers.reduce_sum(w1, dim=1)

    # shared latent vectors: [B, F, k]
    v = fluid.layers.embedding(
        input=feats, size=[vocab_size, embed_dim], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name="fm_v"))

    # FM second-order: 0.5 * sum_k((sum_f v)^2 - sum_f v^2)
    sum_v = fluid.layers.reduce_sum(v, dim=1)              # [B, k]
    sum_v_sq = fluid.layers.square(sum_v)
    v_sq = fluid.layers.square(v)
    sq_sum_v = fluid.layers.reduce_sum(v_sq, dim=1)        # [B, k]
    fm = fluid.layers.scale(
        fluid.layers.reduce_sum(
            fluid.layers.elementwise_sub(sum_v_sq, sq_sum_v),
            dim=1, keep_dim=True),
        scale=0.5)                                          # [B, 1]

    # deep tower over the flattened field embeddings
    deep = fluid.layers.reshape(v, shape=[-1, num_fields * embed_dim])
    for width in deep_layers:
        deep = fluid.layers.fc(input=deep, size=width, act="relu")
    deep = fluid.layers.fc(input=deep, size=1, act=None)

    logit = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(first, fm), deep)
    predict = fluid.layers.sigmoid(logit)
    cost = fluid.layers.sigmoid_cross_entropy_with_logits(x=logit,
                                                          label=label)
    avg_cost = fluid.layers.mean(cost)

    if lr is not None:
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return feats, label, predict, avg_cost
