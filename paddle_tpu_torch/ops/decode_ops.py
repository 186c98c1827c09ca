"""Decode-step ops for continuous batching (counterpart of
``paddle_tpu/ops/decode_ops.py``): ``kv_cache_update``, ``token_select`` and
``paged_attention`` for the decode step, and the speculative verify's pair
``kv_cache_scatter`` and ``spec_accept``.

All are row-independent over the slot dim: a slot's token stream is a
function of its own prompt and cache rows only, which is what makes
continuous-batching output bitwise identical to per-request sequential
decode within the port.

``kv_cache_update`` and ``kv_cache_scatter`` write the persistable cache
tensor IN PLACE and return that same tensor as their output: the
reference's ops are functional and rely on XLA buffer donation to avoid a
copy; eager PyTorch gets the same effect by mutating the scope's tensor, so
nothing reads a cache var's old value after its update (the decode programs
write before they read), and a captured CUDA graph keeps the cache's
address.  None of them reads a value on the host, so each can be captured.
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


@register_op("kv_cache_scatter")
def kv_cache_scatter(ctx):
    """Cache [R, W, ...], New [n, ...], Rows [n] int, Offs [n] int ->
    Cache with ``New[j]`` written at ``Cache[Rows[j], Offs[j]]``; a slot may
    appear in ``Rows`` many times as long as each (row, offset) pair is
    unique.

    A lane whose row or offset lies outside the cache writes nothing, as
    the reference's JAX scatter drops it: the dense verify steers its
    masked lanes to row ``max_slots`` on purpose.  Such a lane is not
    clamped (that would write into a live slot); it repeats the first
    in-range lane's write, same place and same value, so the one scatter
    stays deterministic with no host read.  With no lane in range, every
    lane writes ``Cache[0, 0]`` back onto itself."""
    cache = ctx.input("Cache")
    new = ctx.input("New").to(cache.dtype)
    rows = ctx.input("Rows").reshape(-1).long()
    offs = ctx.input("Offs").reshape(-1).long()
    n = rows.shape[0]
    new = new.reshape((n,) + tuple(cache.shape[2:]))
    live = ((rows >= 0) & (rows < cache.shape[0])
            & (offs >= 0) & (offs < cache.shape[1]))
    lane = torch.arange(n, device=rows.device)
    first = torch.argmax(live.to(torch.int32))  # 0 when no lane is live
    src = torch.where(live, lane, first)
    any_live = live.any()
    zero = torch.zeros_like(rows)
    r = torch.where(any_live, rows[src], zero)
    o = torch.where(any_live, offs[src], zero)
    keep = cache[0, 0].unsqueeze(0).expand_as(new)
    cache[r, o] = torch.where(
        any_live.reshape((1,) * new.dim()), new[src], keep)
    return {"Out": cache}


@register_op("spec_accept")
def spec_accept(ctx):
    """Logits [S, k+1, V], Draft [S, k] int (+ optional Mask [S]) ->
    Tokens [S, k+1] int64 (the argmax at every scored position, ties to
    the lowest index as ``token_select``), NumAccept [S] int64 (the longest
    prefix with ``Draft[s, i] == Tokens[s, i]``).  The engine consumes
    ``Tokens[s, :n+1]``: n accepted drafts and the correction, every one a
    target argmax.  Inactive slots (mask == 0) emit ``end_id`` and accept
    0."""
    toks = torch.argmax(ctx.input("Logits"), dim=-1)
    match = (ctx.input("Draft").long() == toks[:, :-1]).long()
    nacc = torch.cumprod(match, dim=1).sum(dim=1)
    mask = ctx.input("Mask") if ctx.has_input("Mask") else None
    if mask is not None:
        live = mask.reshape(-1) > 0
        toks = torch.where(live[:, None], toks,
                           torch.full_like(toks, int(ctx.attr("end_id", 0))))
        nacc = torch.where(live, nacc, torch.zeros_like(nacc))
    return {"Tokens": toks, "NumAccept": nacc}


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
