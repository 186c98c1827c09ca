"""Decode-step ops for continuous batching (counterpart of
``paddle_tpu/ops/decode_ops.py``): ``kv_cache_update``, ``token_select`` and
``paged_attention``.

All three are row-independent over the slot dim: a slot's token stream is a
function of its own prompt and cache rows only, which is what makes
continuous-batching output bitwise identical to per-request sequential
decode within the port.

``kv_cache_update`` writes the persistable cache tensor IN PLACE and returns
that same tensor as its output: the reference's op is functional and relies
on XLA buffer donation to avoid a copy; eager PyTorch gets the same effect
by mutating the scope's tensor, so nothing reads a cache var's old value
after its update (the decode programs write before they read).
"""

from __future__ import annotations

import torch

from .paged_attention import paged_attention
from .registry import register_op

__all__ = []


@register_op("kv_cache_update")
def kv_cache_update(ctx):
    """Cache [R, L, ...], New [n, w, ...], Slots [n] int, Pos [n] int ->
    Cache with ``New[j]`` written at ``Cache[Slots[j], Pos[j]:Pos[j]+w]``.

    Matches the reference's semantics exactly: the window start clamps to
    ``[0, L - w]`` (``dynamic_update_slice``), and when a row appears more
    than once (inactive slots and prefill pad pages all aim at the trash
    page) the LAST entry wins — whole row, as the reference's row scatter
    does.  Every duplicate writes the last entry's window, so the unordered
    device scatter is deterministic with no host round trip."""
    cache = ctx.input("Cache")
    new = ctx.input("New").to(cache.dtype)
    slots = ctx.input("Slots").reshape(-1).long()
    pos = ctx.input("Pos").reshape(-1).long()
    n, w = new.shape[0], new.shape[1]
    start = pos.clamp(0, cache.shape[1] - w)
    order = torch.arange(n, device=slots.device)
    same = slots[:, None] == slots[None, :]
    last = torch.where(same, order[None, :], -1).amax(dim=1)
    cols = start[last][:, None] + torch.arange(w, device=slots.device)[None, :]
    cache[slots[:, None], cols] = new[last]
    return {"Out": cache}


@register_op("paged_attention")
def paged_attention_op(ctx):
    """Q [S, 1, D], CacheK/CacheV [P + 1, ps, D], PageTable [S, n] int,
    Bias [S, 1, n·ps] -> Out [S, 1, D].  The wrapper launches the CUDA
    kernel for CUDA tensors and the plain PyTorch version for CPU tensors.
    The ``fused`` attr is kept in the IR for equality with the reference and
    not read."""
    return {"Out": paged_attention(
        ctx.input("Q"), ctx.input("CacheK"), ctx.input("CacheV"),
        ctx.input("PageTable"), ctx.input("Bias"),
        float(ctx.attr("scale", 1.0)))}


@register_op("token_select")
def token_select(ctx):
    """Logits [S, V] (+ optional Mask [S]) -> Out [S] int64: per-slot greedy
    argmax, ties to the lowest index; inactive slots (mask == 0) emit
    ``end_id``."""
    out = torch.argmax(ctx.input("Logits"), dim=-1)
    mask = ctx.input("Mask") if ctx.has_input("Mask") else None
    if mask is not None:
        out = torch.where(mask.reshape(-1) > 0, out,
                          torch.full_like(out, int(ctx.attr("end_id", 0))))
    return {"Out": out}
