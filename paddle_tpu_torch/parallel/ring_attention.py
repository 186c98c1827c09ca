"""Attention without the flash kernels (counterpart of
``paddle_tpu/parallel/ring_attention.py``).

Only :func:`full_attention` is ported: the single-device full-softmax
attention the ``ring_attention`` op runs when flash is off or the bias is
not a key-padding bias.  The sequence-parallel ring (``_block_attend``,
``_ring_body``, ``ring_attention``: K/V blocks rotating over an ``sp`` mesh
axis with an online softmax) waits for the multi-GPU slice, where
``torch.distributed`` takes the place of ``lax.ppermute``.
"""

from __future__ import annotations

import torch


def full_attention(q, k, v, causal: bool = False, scale=None, bias=None):
    """``softmax(scale · q kᵀ + bias [+ causal]) v`` over ``[B, H, T, D]``
    with a plain softmax; the causal mask is top-left aligned (query i sees
    keys j ≤ i) and fills ``-inf``.  Both products follow ``fluid.amp``
    (``amp.einsum``, the reference's ``_amp_einsum``)."""
    from ..fluid import amp

    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = amp.einsum("bhqd,bhkd->bhqk", q, k)
    s = s * amp.weak_scalar(scale, s.dtype)
    if bias is not None:
        s = s + bias
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(mask, s, float("-inf"))
    if amp.is_low_float(s.dtype):
        # the reference's jax.nn.softmax in the scores' own dtype: the
        # exponentials, their sum and the quotient each rounded to it
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1)
    return amp.einsum("bhqk,bhkd->bhqd", p, v)
