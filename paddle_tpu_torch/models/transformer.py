"""Transformer (counterpart of ``paddle_tpu/models/transformer.py``): the
encoder-decoder training graph (``build``) and the step-form decoder-only
LM the continuous-batching engine drives token by token (``DecodeModel``).
The builders are the reference's, call for call, so both packages build
the same Programs.

Training runs the unfused attention chain (matmul -> softmax -> matmul).
Flash attention, ring attention, the stacked layer-stack ops and MoE
feed-forward layers are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import fluid
from ..fluid import layers
from ..fluid.initializer import NumpyArrayInitializer
from ..fluid.param_attr import ParamAttr

_NEG_INF = -1e9


class Config:
    """The reference's fields that the port's builders read.
    ``flash_attention`` None (auto) resolves to off in the port; True,
    ``ring_attention``, ``stacked`` and ``moe_experts`` are not ported yet
    (the builders raise).  The MoE routing, pipeline and recompute fields
    come with their slices."""

    def __init__(self, name, src_vocab_size, tgt_vocab_size, d_model,
                 d_inner, n_head, n_layer, dropout=0.1, label_smooth=0.1,
                 moe_experts=0, stacked=False, ring_attention=False,
                 flash_attention=None):
        self.name = name
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.label_smooth = label_smooth
        self.moe_experts = moe_experts
        self.stacked = stacked
        self.ring_attention = ring_attention
        self.flash_attention = flash_attention


def base_config():
    """Transformer-base (Vaswani et al.): d_model 512, 8 heads, 6 layers."""
    return Config("base", src_vocab_size=30000, tgt_vocab_size=30000,
                  d_model=512, d_inner=2048, n_head=8, n_layer=6)


def tiny_config():
    """CPU-test scale."""
    return Config("tiny", src_vocab_size=1000, tgt_vocab_size=1000,
                  d_model=64, d_inner=128, n_head=4, n_layer=2)


def decode_lm_config():
    """Decoder-only LM at CPU-test scale: self-attention only, single head,
    no dropout — the deterministic greedy-decode model."""
    return Config("decode_lm", src_vocab_size=64, tgt_vocab_size=64,
                  d_model=16, d_inner=32, n_head=1, n_layer=2,
                  dropout=0.0, label_smooth=0.0)


def _position_encoding(max_len, d_model):
    """Sinusoid table [max_len, d_model] (Vaswani et al. eq. 5)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


def _shared_causal_bias(lq, lk):
    """One additive triu causal mask per (program, shape), shared by every
    layer."""
    prog = fluid.default_main_program()
    cache = getattr(prog, "_causal_bias_cache", None)
    if cache is None:
        cache = prog._causal_bias_cache = {}
    var = cache.get((lq, lk))
    if var is None:
        causal_np = np.triu(np.full((lq, lk), _NEG_INF, np.float32), k=1)
        var = cache[(lq, lk)] = layers.assign(causal_np)
    return var


def _postprocess(prev, out, dropout):
    """Residual add + layer norm (+ dropout on the sublayer output)."""
    if dropout:
        out = layers.dropout(out, dropout_prob=dropout)
    return layers.layer_norm(layers.elementwise_add(prev, out),
                             begin_norm_axis=2)


def _multi_head_attention(q_in, k_in, v_in, bias, d_model, n_head,
                          dropout, prefix, causal=False):
    """[b, lq, d] x [b, lk, d] -> [b, lq, d]; bias broadcasts into the
    [b, h, lq, lk] logits (None, [lq, lk] causal, or [b, 1, 1, lk]
    padding).  The unfused chain: scaled q.k^T, biases, softmax, dropout
    on the probabilities, times v."""
    lq, lk = q_in.shape[1], k_in.shape[1]
    d_k = d_model // n_head
    q = layers.fc(q_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_q_w"))
    k = layers.fc(k_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_k_w"))
    v = layers.fc(v_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_v_w"))
    # [b, l, d] -> [b, h, l, d_k]
    q = layers.transpose(layers.reshape(q, [-1, lq, n_head, d_k]),
                         perm=[0, 2, 1, 3])
    k = layers.transpose(layers.reshape(k, [-1, lk, n_head, d_k]),
                         perm=[0, 2, 1, 3])
    v = layers.transpose(layers.reshape(v, [-1, lk, n_head, d_k]),
                         perm=[0, 2, 1, 3])
    logits = layers.matmul(layers.scale(q, scale=d_k ** -0.5), k,
                           transpose_y=True)
    if causal:
        logits = layers.elementwise_add(logits, _shared_causal_bias(lq, lk))
    if bias is not None:
        logits = layers.elementwise_add(logits, bias)
    weights = layers.softmax(logits)
    if dropout:
        weights = layers.dropout(weights, dropout_prob=dropout)
    ctx = layers.matmul(weights, v)                      # [b, h, lq, d_k]
    ctx = layers.reshape(layers.transpose(ctx, perm=[0, 2, 1, 3]),
                         [-1, lq, d_model])
    return layers.fc(ctx, d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(name=f"{prefix}_o_w"))


def _ffn(x, d_inner, d_model, prefix):
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=f"{prefix}_ffn1_w"))
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{prefix}_ffn2_w"))


def _embed(word, vocab_size, seq_len, cfg, name):
    emb = layers.embedding(
        word, size=[vocab_size, cfg.d_model],
        param_attr=ParamAttr(
            name=f"{name}_emb",
            initializer=fluid.initializer.NormalInitializer(
                0.0, cfg.d_model ** -0.5)))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    pos = layers.create_parameter(
        shape=[seq_len, cfg.d_model], dtype="float32",
        attr=ParamAttr(name=f"{name}_pos_enc",
                       initializer=NumpyArrayInitializer(
                           _position_encoding(seq_len, cfg.d_model)),
                       trainable=False))
    out = layers.elementwise_add(emb, pos)
    if cfg.dropout:
        out = layers.dropout(out, dropout_prob=cfg.dropout)
    return out


def _padding_bias(word, seq_len):
    """[b, len] int ids -> additive bias [b, 1, 1, len]: NEG_INF at pad(0)."""
    zeros = layers.fill_constant_batch_size_like(
        word, shape=[-1, seq_len], dtype="int64", value=0)
    is_pad = layers.cast(layers.equal(word, zeros), "float32")
    bias = layers.scale(is_pad, scale=_NEG_INF)
    return layers.reshape(bias, [-1, 1, 1, seq_len])


def _check_ported(cfg):
    """The reference's other attention and layer paths are later slices
    (ROADMAP: the flash slice, the MoE and pipeline items)."""
    for field, what in (("flash_attention", "flash attention (the flash "
                         "slice)"), ("ring_attention", "ring attention (the "
                         "flash slice)"), ("stacked", "the stacked layer-"
                         "stack ops"), ("moe_experts", "MoE feed-forward "
                         "layers")):
        if getattr(cfg, field, None):
            raise NotImplementedError(
                f"Config.{field}: {what} is not ported yet; see ROADMAP.md")


def encoder(src_word, cfg, src_len):
    _check_ported(cfg)
    enc = _embed(src_word, cfg.src_vocab_size, src_len, cfg, "src")
    src_bias = _padding_bias(src_word, src_len)
    for i in range(cfg.n_layer):
        attn = _multi_head_attention(
            enc, enc, enc, src_bias, cfg.d_model, cfg.n_head, cfg.dropout,
            prefix=f"enc{i}_self")
        enc = _postprocess(enc, attn, cfg.dropout)
        ff = _ffn(enc, cfg.d_inner, cfg.d_model, prefix=f"enc{i}")
        enc = _postprocess(enc, ff, cfg.dropout)
    return enc, src_bias


def decoder(tgt_word, enc_out, src_bias, cfg, tgt_len):
    _check_ported(cfg)
    dec = _embed(tgt_word, cfg.tgt_vocab_size, tgt_len, cfg, "tgt")
    for i in range(cfg.n_layer):
        self_attn = _multi_head_attention(
            dec, dec, dec, None, cfg.d_model, cfg.n_head, cfg.dropout,
            prefix=f"dec{i}_self", causal=True)
        dec = _postprocess(dec, self_attn, cfg.dropout)
        cross = _multi_head_attention(
            dec, enc_out, enc_out, src_bias, cfg.d_model, cfg.n_head,
            cfg.dropout, prefix=f"dec{i}_cross")
        dec = _postprocess(dec, cross, cfg.dropout)
        ff = _ffn(dec, cfg.d_inner, cfg.d_model, prefix=f"dec{i}")
        dec = _postprocess(dec, ff, cfg.dropout)
    return layers.fc(dec, cfg.tgt_vocab_size, num_flatten_dims=2,
                     param_attr=ParamAttr(name="out_proj_w"))


def forward(cfg, src_len, tgt_len):
    """Build data layers + logits + label-smoothed CE loss.  Returns
    (src_word, tgt_word, lbl_word, avg_cost, logits)."""
    src_word = layers.data(name="src_word", shape=[src_len], dtype="int64")
    tgt_word = layers.data(name="tgt_word", shape=[tgt_len], dtype="int64")
    lbl_word = layers.data(name="lbl_word", shape=[tgt_len, 1], dtype="int64")

    enc_out, src_bias = encoder(src_word, cfg, src_len)
    logits = decoder(tgt_word, enc_out, src_bias, cfg, tgt_len)

    if cfg.label_smooth:
        hot = layers.one_hot(lbl_word, cfg.tgt_vocab_size)
        smooth = layers.label_smooth(hot, epsilon=cfg.label_smooth)
        cost = layers.softmax_with_cross_entropy(logits, smooth,
                                                 soft_label=True)
    else:
        cost = layers.softmax_with_cross_entropy(logits, lbl_word)
    # mask loss at pad targets so padding doesn't dilute the objective
    zeros = layers.fill_constant_batch_size_like(
        lbl_word, shape=[-1, tgt_len, 1], dtype="int64", value=0)
    non_pad = layers.cast(
        layers.logical_not(layers.equal(lbl_word, zeros)), "float32")
    cost = layers.elementwise_mul(cost, non_pad)
    avg_cost = layers.elementwise_div(
        layers.reduce_sum(cost),
        layers.elementwise_add(layers.reduce_sum(non_pad),
                               layers.fill_constant([1], "float32", 1e-8)))
    return src_word, tgt_word, lbl_word, avg_cost, logits


def build(cfg=None, src_len=64, tgt_len=64, lr=1e-3, warmup_steps=None):
    """Full training graph with Adam.  Returns (src_word, tgt_word,
    lbl_word, avg_cost).  The noam schedule (``warmup_steps``) is not
    ported yet."""
    if warmup_steps:
        raise NotImplementedError("the noam learning-rate schedule "
                                  "(warmup_steps) is not ported yet")
    cfg = cfg or tiny_config()
    src_word, tgt_word, lbl_word, avg_cost, _ = forward(cfg, src_len, tgt_len)
    opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                               epsilon=1e-9)
    opt.minimize(avg_cost)
    return src_word, tgt_word, lbl_word, avg_cost


class DecodeModel:
    """Step-form decoder-only transformer LM.

    Program families sharing parameters AND per-layer KV caches BY NAME
    through one scope:

     - ``startup``: every weight plus the per-layer ``dlm{i}_cache_k/v``
       caches — the dense ``[max_slots, max_len, d_model]`` slot cache, or
       in paged mode the ``[num_pages + 1, page_size, d_model]`` page pool
       whose last row is the trash page;
     - ``step_program``: ONE fixed-shape program over ALL slots — embed the
       last token, project q/k/v, ``kv_cache_update`` this tick's K/V,
       attend over the cache row under a host-fed ``-inf`` validity bias
       (``paged_attention`` in paged mode), project logits,
       ``token_select`` greedily;
     - ``prefill_program(plen)``: one program per prompt-length bucket:
       causal attention over the prompt window and a ``kv_cache_update``
       scatter of the whole K/V prefix.  No logits — the first decode tick
       re-derives position ``len-1`` and emits the first token.

    Bitwise sequential-equivalence: every op is row-independent over the
    slot dim and masked cache positions contribute exactly zero, so a
    stream's tokens are a function of its own prompt alone.  The executor
    updates the caches in place in the scope.  Speculative verify
    (``spec_program``) is not ported yet."""

    DC_TOKENS, DC_POSENC, DC_BIAS, DC_POS, DC_ACTIVE = (
        "dc_tokens", "dc_posenc", "dc_bias", "dc_pos", "dc_active")
    DC_PTABLE, DC_WPAGE, DC_WOFF = "dc_ptable", "dc_wpage", "dc_woff"
    PF_TOKENS, PF_SLOT = "pf_tokens", "pf_slot"
    PF_PAGES = "pf_pages"

    def __init__(self, cfg=None, max_slots=None, max_len=None,
                 prefill_buckets=None, end_id=1, seed=7, paged=None,
                 page_size=None, num_pages=None):
        from ..fluid import envcontract as _ec

        self.cfg = cfg or decode_lm_config()
        if self.cfg.dropout:
            raise ValueError("decode models must be deterministic: "
                             "build the config with dropout=0")
        self.max_slots = int(max_slots if max_slots is not None
                             else _ec.get("PADDLE_SERVE_SLOTS"))
        self.max_len = int(max_len if max_len is not None
                           else _ec.get("PADDLE_SERVE_MAX_LEN"))
        if prefill_buckets is None:
            raw = _ec.get("PADDLE_SERVE_PREFILL_BUCKETS") or ""
            prefill_buckets = [int(b) for b in str(raw).split(",") if b]
        self.prefill_buckets = sorted(
            {int(b) for b in prefill_buckets if int(b) <= self.max_len})
        if not self.prefill_buckets:
            raise ValueError(
                f"no viable prefill bucket <= max_len ({self.max_len})")
        self.paged = bool(_ec.get("PADDLE_SERVE_PAGED")) if paged is None \
            else bool(paged)
        if self.paged:
            self.page_size = int(page_size if page_size is not None
                                 else _ec.get("PADDLE_SERVE_PAGE_SIZE"))
            if self.page_size < 1 or self.max_len % self.page_size:
                raise ValueError(
                    f"page_size ({self.page_size}) must divide max_len "
                    f"({self.max_len})")
            bad = [b for b in self.prefill_buckets if b % self.page_size]
            if bad:
                raise ValueError(
                    f"page_size ({self.page_size}) must divide every "
                    f"prefill bucket; {bad} are not divisible")
            self.pages_per_slot = self.max_len // self.page_size
            np_req = int(num_pages if num_pages is not None
                         else _ec.get("PADDLE_SERVE_NUM_PAGES"))
            # 0 = auto: dense-equal capacity
            self.num_pages = np_req or self.max_slots * self.pages_per_slot
            if self.num_pages < self.pages_per_slot:
                raise ValueError(
                    f"num_pages ({self.num_pages}) cannot hold even one "
                    f"full slot ({self.pages_per_slot} pages)")
            self.trash_page = self.num_pages
        else:
            self.page_size = self.num_pages = self.trash_page = None
            self.pages_per_slot = None
        self.end_id = int(end_id)
        self.seed = int(seed)
        self.vocab_size = int(self.cfg.tgt_vocab_size)
        self.pos_table = _position_encoding(self.max_len, self.cfg.d_model)
        self.startup = fluid.Program()
        self._prefill = {}
        self.step_program, self.step_fetch, self.logits_fetch = \
            self._build_step()

    # -- graph pieces shared by the step and prefill programs --

    def _cache_var(self, name):
        """The persistable cache param (zero-init, frozen)."""
        from ..fluid.initializer import ConstantInitializer
        from ..fluid.layers import tensor as _tensor

        shape = ([self.num_pages + 1, self.page_size, self.cfg.d_model]
                 if self.paged
                 else [self.max_slots, self.max_len, self.cfg.d_model])
        return _tensor.create_parameter(
            shape=shape, dtype="float32",
            attr=ParamAttr(name=name, trainable=False,
                           initializer=ConstantInitializer(0.0)))

    def _layer(self, x, i, attn):
        """One decoder layer over x [n, t, D]; ``attn(q, k, v)`` supplies
        the cache-backed (step) or windowed-causal (prefill) attention."""
        d, f = self.cfg.d_model, self.cfg.d_inner
        proj = dict(num_flatten_dims=2, bias_attr=False)
        q = layers.fc(x, d, param_attr=ParamAttr(name=f"dlm{i}_q_w"), **proj)
        k = layers.fc(x, d, param_attr=ParamAttr(name=f"dlm{i}_k_w"), **proj)
        v = layers.fc(x, d, param_attr=ParamAttr(name=f"dlm{i}_v_w"), **proj)
        ctx = attn(q, k, v)
        o = layers.fc(ctx, d, param_attr=ParamAttr(name=f"dlm{i}_o_w"),
                      **proj)
        x = layers.layer_norm(
            layers.elementwise_add(x, o), begin_norm_axis=2,
            param_attr=ParamAttr(name=f"dlm{i}_ln1_s"),
            bias_attr=ParamAttr(name=f"dlm{i}_ln1_b"))
        h = layers.fc(x, f, act="relu",
                      param_attr=ParamAttr(name=f"dlm{i}_ffn1_w"), **proj)
        ff = layers.fc(h, d, param_attr=ParamAttr(name=f"dlm{i}_ffn2_w"),
                       **proj)
        return layers.layer_norm(
            layers.elementwise_add(x, ff), begin_norm_axis=2,
            param_attr=ParamAttr(name=f"dlm{i}_ln2_s"),
            bias_attr=ParamAttr(name=f"dlm{i}_ln2_b"))

    def _embed(self, tokens, posenc_var):
        emb = layers.embedding(tokens, size=[self.vocab_size,
                                             self.cfg.d_model],
                               param_attr=ParamAttr(name="dlm_emb"))
        return layers.elementwise_add(
            layers.scale(emb, scale=self.cfg.d_model ** 0.5), posenc_var,
            axis=emb.shape and len(emb.shape) - len(posenc_var.shape))

    # -- the one decode step --

    def _build_step(self):
        s, l = self.max_slots, self.max_len
        d, v = self.cfg.d_model, self.vocab_size
        prog = fluid.Program()
        prog.random_seed = self.startup.random_seed = self.seed
        with fluid.program_guard(prog, self.startup), \
                fluid.unique_name.guard():
            tokens = layers.data(self.DC_TOKENS, shape=[s, 1],
                                 dtype="int64", append_batch_size=False)
            posenc = layers.data(self.DC_POSENC, shape=[s, d],
                                 dtype="float32", append_batch_size=False)
            bias = layers.data(self.DC_BIAS, shape=[s, 1, l],
                               dtype="float32", append_batch_size=False)
            pos = layers.data(self.DC_POS, shape=[s], dtype="int64",
                              append_batch_size=False)
            active = layers.data(self.DC_ACTIVE, shape=[s],
                                 dtype="float32", append_batch_size=False)
            slots = layers.assign(np.arange(s, dtype=np.int64))
            if self.paged:
                # slot->page indirection, fed fresh each tick; gathered
                # length pages_per_slot * page_size == max_len, so the same
                # [S, 1, L] validity bias masks trash/stale pages
                ptable = layers.data(
                    self.DC_PTABLE, shape=[s, self.pages_per_slot],
                    dtype="int64", append_batch_size=False)
                wpage = layers.data(self.DC_WPAGE, shape=[s],
                                    dtype="int64", append_batch_size=False)
                woff = layers.data(self.DC_WOFF, shape=[s],
                                   dtype="int64", append_batch_size=False)

            x = layers.reshape(self._embed(tokens, posenc), [s, 1, d])

            def cache_attn(q, k, v_, i):
                ck = self._cache_var(f"dlm{i}_cache_k")
                cv = self._cache_var(f"dlm{i}_cache_v")
                # write BEFORE reading so position `pos` (this token)
                # participates in its own attention window
                if self.paged:
                    ck = layers.kv_cache_update(ck, k, wpage, woff)
                    cv = layers.kv_cache_update(cv, v_, wpage, woff)
                    return layers.paged_attention(
                        layers.scale(q, scale=d ** -0.5), ck, cv,
                        ptable, bias, scale=1.0)             # [S, 1, D]
                ck = layers.kv_cache_update(ck, k, slots, pos)
                cv = layers.kv_cache_update(cv, v_, slots, pos)
                scores = layers.matmul(
                    layers.scale(q, scale=d ** -0.5), ck,
                    transpose_y=True)                        # [S, 1, L]
                probs = layers.softmax(
                    layers.elementwise_add(scores, bias))
                return layers.matmul(probs, cv)              # [S, 1, D]

            for i in range(self.cfg.n_layer):
                x = self._layer(x, i,
                                lambda q, k, v_, i=i: cache_attn(q, k, v_, i))
            logits = layers.fc(layers.reshape(x, [s, d]), v,
                               bias_attr=False,
                               param_attr=ParamAttr(name="dlm_out_w"))
            nxt = layers.token_select(logits, mask=active,
                                      end_id=self.end_id)
        return prog, nxt.name, logits.name

    # -- bucketed prefill --

    def bucket_for(self, prompt_len):
        """Smallest prefill bucket holding ``prompt_len`` (None = none)."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        return None

    def prefill_program(self, plen):
        """The (lazily built, cached) prefill program for bucket ``plen``.
        Weights come from the step program's startup — this builder's
        throwaway startup is never run."""
        prog = self._prefill.get(plen)
        if prog is not None:
            return prog
        if plen not in self.prefill_buckets:
            raise ValueError(f"{plen} is not a prefill bucket "
                             f"({self.prefill_buckets})")
        d = self.cfg.d_model
        prog, scratch_startup = fluid.Program(), fluid.Program()
        prog.random_seed = scratch_startup.random_seed = self.seed
        with fluid.program_guard(prog, scratch_startup), \
                fluid.unique_name.guard():
            tokens = layers.data(self.PF_TOKENS, shape=[1, plen],
                                 dtype="int64", append_batch_size=False)
            if self.paged:
                # the K/V window is cut into page-sized chunks scattered to
                # wherever the pool placed them (pad pages get the trash)
                n_pp = plen // self.page_size
                pages = layers.data(self.PF_PAGES, shape=[n_pp],
                                    dtype="int64", append_batch_size=False)
                zeros = layers.fill_constant([n_pp], "int64", 0)
            else:
                slot = layers.data(self.PF_SLOT, shape=[1], dtype="int64",
                                   append_batch_size=False)
                start = layers.fill_constant([1], "int64", 0)
            posenc = layers.assign(self.pos_table[:plen])     # [p, D]
            x = self._embed(tokens, posenc)                   # [1, p, D]

            def window_attn(q, k, v_, i):
                ck = self._cache_var(f"dlm{i}_cache_k")
                cv = self._cache_var(f"dlm{i}_cache_v")
                if self.paged:
                    kr = layers.reshape(k, [n_pp, self.page_size, d])
                    vr = layers.reshape(v_, [n_pp, self.page_size, d])
                    layers.kv_cache_update(ck, kr, pages, zeros)
                    layers.kv_cache_update(cv, vr, pages, zeros)
                else:
                    layers.kv_cache_update(ck, k, slot, start)
                    layers.kv_cache_update(cv, v_, slot, start)
                # the prompt window attends within itself (causal); the
                # cache is write-only here — decode ticks read it
                scores = layers.matmul(
                    layers.scale(q, scale=d ** -0.5), k,
                    transpose_y=True)                        # [1, p, p]
                scores = layers.elementwise_add(
                    scores, _shared_causal_bias(plen, plen), axis=1)
                return layers.matmul(layers.softmax(scores), v_)

            for i in range(self.cfg.n_layer):
                x = self._layer(x, i,
                                lambda q, k, v_, i=i: window_attn(q, k, v_, i))
        self._prefill[plen] = prog
        return prog

    # -- host-side helpers the engine uses to build tick feeds --

    def posenc_rows(self, positions):
        """pos_table rows for an int position vector (clipped in-range)."""
        idx = np.clip(np.asarray(positions, np.int64), 0, self.max_len - 1)
        return self.pos_table[idx]

    def validity_bias(self, positions):
        """[S, 1, L] additive bias: 0 where cache index <= pos, EXACT -inf
        elsewhere, so stale rows contribute exactly zero weight."""
        pos = np.asarray(positions, np.int64).reshape(-1, 1)
        idx = np.arange(self.max_len, dtype=np.int64)[None, :]
        bias = np.where(idx <= pos, 0.0, -np.inf).astype(np.float32)
        return bias.reshape(len(positions), 1, self.max_len)


def load_reference_params(scope, arrays: Dict[str, np.ndarray], place):
    """Carry any persistable set across from the reference (or from another
    port scope): write every ``{name: ndarray}`` — parameters, Adam moments
    and beta pows, the learning-rate var, decode caches — into the port's
    scope tensor of the same name, in place, on ``place``'s device.  Raises
    KeyError for a name the scope does not hold and ValueError/TypeError on
    a shape or dtype mismatch — before writing anything."""
    from ..fluid import core

    device = core.torch_device(place)
    staged = []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        cur = scope.get(name)
        if cur is None:
            raise KeyError(f"the port's scope holds no var named {name!r} "
                           f"(run the model's startup program first)")
        if tuple(cur.shape) != tuple(arr.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} != "
                             f"port shape {tuple(cur.shape)}")
        if core.convert_dtype(cur.dtype) != core.convert_dtype(arr.dtype):
            raise TypeError(f"{name}: reference dtype {arr.dtype} != port "
                            f"dtype {cur.dtype}")
        if cur.device != device:
            raise ValueError(f"{name} lies on {cur.device}, not on "
                             f"{device}")
        staged.append((cur, arr))
    for cur, arr in staged:
        cur.copy_(torch.tensor(arr))
