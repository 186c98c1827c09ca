"""BERT masked-LM + next-sentence pretraining (counterpart of
``paddle_tpu/models/bert.py``, built call for call): learned word,
position and token-type embeddings, the post-LN encoder blocks of
``models/transformer.py``, an MLM head that gathers the masked rows before
the vocabulary projection (``[n_mask, V]`` logits, never ``[B·T, V]``) and
an NSP head on the [CLS] vector.

Attention runs the unfused chain, or with ``flash_attention`` /
``ring_attention`` set the ``ring_attention`` op, which runs the flash
kernels on CUDA tensors (under bf16 AMP the bf16 ones).  ``stacked=True``
builds the encoder as one layer-stack op
(``layers.transformer_encoder_stack``).
"""

from __future__ import annotations

import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr
from .transformer import (_ffn, _multi_head_attention, _padding_bias,
                          _postprocess)


class BertConfig:
    """The reference's fields.  ``flash_attention``: True routes every
    attention through the ``ring_attention`` op and its flash kernels,
    False forbids them, None = on when torch sees a CUDA device when the
    model is built; ``ring_attention`` routes through the same op.
    ``stacked`` builds the encoder as one layer-stack op, its layers
    recomputed in the backward with ``recompute``; ``n_microbatches`` is
    the pipeline's, kept in the IR."""

    def __init__(self, name, vocab_size=30522, d_model=768, d_inner=3072,
                 n_head=12, n_layer=12, type_vocab_size=2, max_len=512,
                 dropout=0.1, ring_attention=False, stacked=False,
                 n_microbatches=4, recompute=False, flash_attention=None):
        self.name = name
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.type_vocab_size = type_vocab_size
        self.max_len = max_len
        self.dropout = dropout
        self.ring_attention = ring_attention
        self.stacked = stacked
        self.n_microbatches = n_microbatches
        self.recompute = recompute
        self.flash_attention = flash_attention


def base_config():
    """BERT-base (Devlin et al.): d_model 768, 12 heads, 12 layers, the
    30522-token WordPiece vocabulary."""
    return BertConfig("base")


def tiny_config():
    """CPU-test scale."""
    return BertConfig("tiny", vocab_size=500, d_model=64, d_inner=128,
                      n_head=4, n_layer=2, max_len=64, dropout=0.0)


def _bert_embed(ids, type_ids, cfg, seq_len):
    word = layers.embedding(
        ids, size=[cfg.vocab_size, cfg.d_model],
        param_attr=ParamAttr(name="bert_word_emb"))
    pos_ids = layers.assign(np.arange(seq_len, dtype=np.int64))
    pos = layers.embedding(
        pos_ids, size=[cfg.max_len, cfg.d_model],
        param_attr=ParamAttr(name="bert_pos_emb"))
    typ = layers.embedding(
        type_ids, size=[cfg.type_vocab_size, cfg.d_model],
        param_attr=ParamAttr(name="bert_type_emb"))
    out = layers.elementwise_add(layers.elementwise_add(word, typ), pos)
    out = layers.layer_norm(out, begin_norm_axis=2)
    if cfg.dropout:
        out = layers.dropout(out, dropout_prob=cfg.dropout)
    return out


def encoder_stack(emb, pad_bias, cfg):
    if getattr(cfg, "stacked", False):
        return layers.transformer_encoder_stack(
            emb, bias=pad_bias, n_layer=cfg.n_layer, n_head=cfg.n_head,
            d_inner=cfg.d_inner, dropout=cfg.dropout,
            n_microbatches=getattr(cfg, "n_microbatches", 4),
            recompute=getattr(cfg, "recompute", False),
            flash=getattr(cfg, "flash_attention", None))
    enc = emb
    for i in range(cfg.n_layer):
        attn = _multi_head_attention(
            enc, enc, enc, pad_bias, cfg.d_model, cfg.n_head, cfg.dropout,
            prefix=f"bert{i}_self",
            use_ring=getattr(cfg, "ring_attention", False),
            flash=getattr(cfg, "flash_attention", None))
        enc = _postprocess(enc, attn, cfg.dropout)
        ff = _ffn(enc, cfg.d_inner, cfg.d_model, prefix=f"bert{i}")
        enc = _postprocess(enc, ff, cfg.dropout)
    return enc


def forward(cfg, seq_len, n_mask):
    """Build the pretraining graph; returns (inputs..., losses, logits).

    Feeds:
      src_ids    int64 [B, seq_len]      token ids (0 = pad)
      type_ids   int64 [B, seq_len]      segment A/B ids
      mask_pos   int64 [B*n_mask]        FLAT positions into [B*T] rows
      mask_label int64 [B*n_mask, 1]     original token at each masked slot
      nsp_label  int64 [B, 1]            is-next-sentence
    """
    src_ids = layers.data(name="src_ids", shape=[seq_len], dtype="int64")
    type_ids = layers.data(name="type_ids", shape=[seq_len], dtype="int64")
    mask_pos = layers.data(name="mask_pos", shape=[1], dtype="int64")
    mask_label = layers.data(name="mask_label", shape=[1], dtype="int64")
    nsp_label = layers.data(name="nsp_label", shape=[1], dtype="int64")

    emb = _bert_embed(src_ids, type_ids, cfg, seq_len)
    pad_bias = _padding_bias(src_ids, seq_len)
    enc = encoder_stack(emb, pad_bias, cfg)   # [B, T, D]

    # MLM head: only the masked rows go through the vocabulary projection
    flat = layers.reshape(enc, shape=[-1, cfg.d_model])     # [B*T, D]
    masked = layers.gather(flat, mask_pos)                  # [B*n_mask, D]
    masked = layers.fc(masked, cfg.d_model, act="relu",
                       param_attr=ParamAttr(name="mlm_transform_w"))
    masked = layers.layer_norm(masked, begin_norm_axis=1)
    mlm_logits = layers.fc(masked, cfg.vocab_size,
                           param_attr=ParamAttr(name="mlm_out_w"))
    mlm_prob = layers.softmax(mlm_logits)
    mlm_loss = layers.mean(layers.cross_entropy(mlm_prob, mask_label))

    # NSP head on the [CLS] (position 0) vector
    cls = layers.slice(enc, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, shape=[-1, cfg.d_model])
    pooled = layers.fc(cls, cfg.d_model, act="tanh",
                       param_attr=ParamAttr(name="bert_pooler_w"))
    nsp_prob = layers.fc(pooled, 2, act="softmax",
                         param_attr=ParamAttr(name="nsp_out_w"))
    nsp_loss = layers.mean(layers.cross_entropy(nsp_prob, nsp_label))

    total = layers.elementwise_add(mlm_loss, nsp_loss)
    return (src_ids, type_ids, mask_pos, mask_label, nsp_label,
            total, mlm_loss, nsp_loss, mlm_prob)


def build(cfg=None, seq_len=128, n_mask=20, lr=1e-4):
    """``forward`` with Adam(lr) minimizing the total loss."""
    cfg = cfg or base_config()
    outs = forward(cfg, seq_len, n_mask)
    total = outs[5]
    fluid.optimizer.Adam(learning_rate=lr).minimize(total)
    return outs


def synthetic_batch(cfg, batch, seq_len, n_mask, rng):
    """Deterministic learnable pretraining batch: each sequence is a Markov
    chain (token i -> perm[i] w.p. 0.9), so MLM is predictable from
    context; NSP label = whether segment B continues the chain."""
    perm = np.random.RandomState(1234).permutation(cfg.vocab_size - 10) + 10
    ids = np.zeros((batch, seq_len), np.int64)
    typ = np.zeros((batch, seq_len), np.int64)
    nsp = np.zeros((batch, 1), np.int64)
    half = seq_len // 2
    for b in range(batch):
        w = int(rng.randint(10, cfg.vocab_size))
        for t in range(seq_len):
            ids[b, t] = w
            nxt = perm[(w - 10) % len(perm)]
            w = int(nxt) if rng.uniform() < 0.9 \
                else int(rng.randint(10, cfg.vocab_size))
        typ[b, half:] = 1
        if rng.uniform() < 0.5:  # corrupt segment B -> not-next
            ids[b, half:] = rng.randint(10, cfg.vocab_size,
                                        size=seq_len - half)
            nsp[b, 0] = 0
        else:
            nsp[b, 0] = 1
    # mask n_mask positions per sequence (not position 0, the CLS slot)
    mask_pos = np.zeros((batch * n_mask,), np.int64)
    mask_label = np.zeros((batch * n_mask, 1), np.int64)
    for b in range(batch):
        pos = rng.choice(np.arange(1, seq_len), size=n_mask, replace=False)
        for j, p in enumerate(pos):
            mask_pos[b * n_mask + j] = b * seq_len + p
            mask_label[b * n_mask + j, 0] = ids[b, p]
            ids[b, p] = 1  # [MASK] id
    return {"src_ids": ids, "type_ids": typ, "mask_pos": mask_pos,
            "mask_label": mask_label, "nsp_label": nsp}
