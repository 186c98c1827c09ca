"""Stacked transformer layer blocks (counterpart of
``paddle_tpu/parallel/transformer_stack.py``): the single-device path.

Every layer's parameters are stacked on a leading ``[L, ...]`` dim and the
stack applies them layer by layer (the reference's ``lax.scan`` over
layers), post-norm residual sublayers: scaled-dot-product attention with
additive biases (the flash kernels when flash is on and the bias is a
key-padding bias, else the plain full attention), a relu FFN, every
product through ``fluid.amp.matmul``.  The GPipe (``pp``), Megatron
(``mp``) and ring-attention (``sp``) layouts come with the multi-GPU
slice (``ROADMAP.md`` queue 1 item 12b); ``ENCODER_SLOTS`` /
``DECODER_SLOTS`` and :func:`dist_spec_for` are here already, since the
layer functions tag the parameters with them.

Dropout is ``fluid.layers.dropout``'s default ``downgrade_in_infer`` on
the sublayer outputs (residual dropout; no attention-probability dropout,
as in the reference).  The reference derives each layer's draws from a
threaded key (``fold_in(key, i)``) and emits the key, so its grad re-runs
the stack with the same masks.  Here the keep masks themselves are what
the forward draws, from the scope's generator as the ``dropout`` op
draws, all before the first layer (:func:`draw_masks`), and what it
emits; the layers take them as inputs.  So a recomputed layer
(``recompute``: ``torch.utils.checkpoint``) draws nothing, the grad sees
the forward's masks with no host sync, and a captured window replays the
draws as it replays the ``dropout`` op's.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from ..ops.flash_attention import FlashAttention, bias_supported
from .ring_attention import full_attention

# slot -> (index of the dim sharded over "mp", or None).  Dim 0 is always
# the stacked layer dim (sharded over "pp" when present).  Column-parallel
# weights split their OUTPUT dim, row-parallel their INPUT dim (Megatron).
ENCODER_SLOTS = {
    "WQ": 2, "WK": 2, "WV": 2,          # [L, d, d]   column
    "WO": 1,                             # [L, d, d]   row
    "FFN1W": 2, "FFN1B": 1,              # [L, d, di] / [L, di] column
    "FFN2W": 1,                          # [L, di, d]  row
    "FFN2B": None,                       # [L, d]      replicated
    "LN1S": None, "LN1B": None, "LN2S": None, "LN2B": None,  # [L, d]
}
DECODER_SLOTS = dict(ENCODER_SLOTS)
DECODER_SLOTS.update({
    "CQ": 2, "CK": 2, "CV": 2, "CO": 1,  # cross-attention projections
    "LN3S": None, "LN3B": None,
})

# dropout sites a layer: the sublayers' outputs
ENCODER_SITES = 2   # self-attention, FFN
DECODER_SITES = 3   # causal self-attention, cross-attention, FFN


def dist_spec_for(slot: str, ndim: int, decoder: bool) -> tuple:
    """Per-dim mesh-axis hints for a stacked param: dim 0 -> "pp", the
    Megatron dim -> "mp"."""
    table = DECODER_SLOTS if decoder else ENCODER_SLOTS
    mp_dim = table[slot]
    spec = ["pp"] + [None] * (ndim - 1)
    if mp_dim is not None:
        spec[mp_dim] = "mp"
    return tuple(spec)


def _layer_norm(x, scale, bias, eps=1e-5):
    """In x's dtype, biased variance, as the reference computes it (its
    weakly typed ``eps`` rounded to x's dtype first)."""
    from ..fluid import amp

    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + amp.weak_scalar(eps, x.dtype)) \
        * scale + bias


def draw_masks(generator, n_layer: int, sites: int, shape, rate: float,
               device) -> torch.Tensor:
    """The keep masks of a whole stack, ``[L, sites, *shape]`` bool: each
    value kept with probability ``1 - rate``, drawn as the ``dropout`` op
    draws (``rand < 1 - rate``), a layer at a time."""
    keep = torch.empty((n_layer, sites) + tuple(shape), dtype=torch.bool,
                       device=device)
    for i in range(n_layer):
        u = torch.rand((sites,) + tuple(shape), device=device,
                       generator=generator)
        torch.lt(u, 1.0 - rate, out=keep[i])
    return keep


def _dropout(x, keep, rate, is_test):
    """``fluid.layers.dropout``'s default (downgrade_in_infer)."""
    from ..fluid import amp

    if not rate:
        return x
    if is_test:
        return x * amp.weak_scalar(1.0 - rate, x.dtype)
    return x * keep.to(x.dtype)


def _site(keep, i):
    return None if keep is None else keep[i]


def _attend(q, k, v, bias, causal, n_head, flash=False):
    """[b, tq, dh] x [b, tk, dh] -> [b, tq, dh] with dh split into
    ``n_head`` heads; bias is [b, 1, 1, tk] or None.  With ``flash`` and a
    key-padding bias the flash kernels (their plain versions on CPU
    tensors), else the full-softmax attention."""
    b, tq, dh = q.shape
    tk = k.shape[1]
    dk = dh // n_head
    q4 = q.reshape(b, tq, n_head, dk).transpose(1, 2)
    k4 = k.reshape(b, tk, n_head, dk).transpose(1, 2)
    v4 = v.reshape(b, tk, n_head, dk).transpose(1, 2)
    scale = dk ** -0.5
    if flash and bias_supported(bias, b, tk):
        ctx = FlashAttention.apply(q4, k4, v4, bias, scale, causal)
    else:
        ctx = full_attention(q4, k4, v4, causal, scale, bias=bias)
    return ctx.transpose(1, 2).reshape(b, tq, dh)


def _mm(a, b):
    """Matmul under the AMP recipe (``fluid.amp.matmul``)."""
    from ..fluid import amp

    return amp.matmul(a, b)


def _mha(p, prefix, x, kv, bias, causal, attend):
    """Projections + attention + output projection for one attention
    sublayer; prefix selects self ("W") or cross ("C") weights."""
    q = _mm(x, p[prefix + "Q"])
    k = _mm(kv, p[prefix + "K"])
    v = _mm(kv, p[prefix + "V"])
    return _mm(attend(q, k, v, bias, causal), p[prefix + "O"])


def _ffn_sublayer(p, x, keep, dropout, is_test, ln):
    h = torch.relu(_mm(x, p["FFN1W"]) + p["FFN1B"])
    ff = _mm(h, p["FFN2W"]) + p["FFN2B"]
    return _layer_norm(x + _dropout(ff, keep, dropout, is_test),
                       p[ln + "S"], p[ln + "B"])


def _encoder_layer(p: Dict[str, torch.Tensor], x, bias, keep, *, attend,
                   dropout, is_test):
    """One post-norm encoder layer.  p holds THIS layer's param slices;
    x: [b, t, d]; bias: [b, 1, 1, t] or None; keep: this layer's
    [ENCODER_SITES, b, t, d] masks or None."""
    attn = _mha(p, "W", x, x, bias, False, attend)
    x = _layer_norm(x + _dropout(attn, _site(keep, 0), dropout, is_test),
                    p["LN1S"], p["LN1B"])
    return _ffn_sublayer(p, x, _site(keep, 1), dropout, is_test, "LN2")


def _decoder_layer(p, x, enc, src_bias, keep, *, attend, dropout, is_test):
    """One post-norm decoder layer: causal self-attn, cross-attn, FFN."""
    sa = _mha(p, "W", x, x, None, True, attend)
    x = _layer_norm(x + _dropout(sa, _site(keep, 0), dropout, is_test),
                    p["LN1S"], p["LN1B"])
    ca = _mha(p, "C", x, enc, src_bias, False, attend)
    x = _layer_norm(x + _dropout(ca, _site(keep, 1), dropout, is_test),
                    p["LN2S"], p["LN2B"])
    return _ffn_sublayer(p, x, _site(keep, 2), dropout, is_test, "LN3")


def _scan_layers(layer_fn, params, x, masks, n_layer, recompute):
    """The reference's ``lax.scan`` over the stacked params as a loop over
    the ``[L, ...]`` slices; with ``recompute`` (and autograd recording a
    graph: some input takes a grad) each layer under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept."""
    checkpoint = recompute and torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in params.values()))
    for i in range(n_layer):
        p = {slot: v[i] for slot, v in params.items()}
        keep = None if masks is None else masks[i]
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                layer_fn, p, x, keep, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x = layer_fn(p, x, keep)
    return x


def stack_apply(kind: str, x, enc, bias, params: Dict[str, torch.Tensor],
                masks: Optional[torch.Tensor], *, n_head: int,
                dropout: float, is_test: bool, recompute: bool = False,
                flash: bool = False):
    """Apply a stacked encoder ('enc') or decoder ('dec') to x.

    x: [N, T, D]; enc: [N, Ts, D] (decoder only); bias: [N, 1, 1, Tk] or
    None (encoder self / decoder cross key bias); params: stacked tensors
    keyed by ENCODER_SLOTS / DECODER_SLOTS; masks: :func:`draw_masks`'s
    ``[L, sites, N, T, D]`` keep masks (None when dropout is 0 or
    ``is_test``).  ``recompute`` checkpoints each layer: the backward
    recomputes activations layer by layer instead of keeping them all.
    """
    decoder = kind == "dec"
    attend = functools.partial(_attend, n_head=n_head, flash=flash)
    if decoder:
        def layer_fn(p, xx, keep):
            return _decoder_layer(p, xx, enc, bias, keep, attend=attend,
                                  dropout=dropout, is_test=is_test)
    else:
        def layer_fn(p, xx, keep):
            return _encoder_layer(p, xx, bias, keep, attend=attend,
                                  dropout=dropout, is_test=is_test)
    return _scan_layers(layer_fn, params, x, masks, params["WQ"].shape[0],
                        recompute)
