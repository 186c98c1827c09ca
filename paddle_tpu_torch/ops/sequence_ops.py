"""Sequence (LoD) ops (counterpart of ``paddle_tpu/ops/sequence_ops.py``).

Sequences stay packed (``[sum_len, ...]``, the reference's LoD layout) and
the offsets are host metadata the Executor hands each op
(``ExecContext.in_lod`` / ``seq_offsets``).  All index math is numpy on
the host, as in the reference's trace; the index tensors it gives are
cached on the device per (offsets, device) (:func:`device_index`), so a
fixed-bucket step pays no host-to-device copy per op.  The reductions the
reference takes from ``jax.ops.segment_*`` are ``index_add`` and
``scatter_reduce`` here; a maximum's grad is split evenly among tied
rows, as the reference's ``segment_max`` grad splits it.

Where the reference reads a tensor's values on the host (``_concrete``:
``sequence_slice``'s offsets and lengths, ``sequence_unpad``'s lengths
without a LoD, ``sequence_mask``'s ``maxlen=-1``, ``lod_reset`` from a
tensor), the port reads them once with ``.tolist()``.  ``sequence_erase``
and ``sub_nested_seq`` read their data on the host (their output rows
depend on it: ``registry.EAGER_OPS``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .registry import register_grad, register_op

_INDEX_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_INDEX_CACHE_CAP = 256


def cached(key: tuple, build):
    """``build()``, made once per ``key`` (a tuple of host metadata and the
    device) and kept, least recently used out past ``_INDEX_CACHE_CAP``
    entries.  What it keeps is never written."""
    v = _INDEX_CACHE.get(key)
    if v is None:
        v = _INDEX_CACHE[key] = build()
        if len(_INDEX_CACHE) > _INDEX_CACHE_CAP:
            _INDEX_CACHE.popitem(last=False)
    else:
        _INDEX_CACHE.move_to_end(key)
    return v


def device_index(key: tuple, device, build) -> torch.Tensor:
    """``build()`` (a numpy array made from host metadata) as a tensor on
    ``device``, cached per ``(key, device)``."""
    return cached(key + (str(device),),
                  lambda: torch.as_tensor(build(), device=device))


def _lengths(off) -> np.ndarray:
    off = np.asarray(off, np.int64)
    return off[1:] - off[:-1]


def _seg_ids(off) -> np.ndarray:
    return np.repeat(np.arange(len(off) - 1), _lengths(off))


def _cum_offsets(lengths) -> tuple:
    return tuple(np.concatenate([[0], np.cumsum(lengths)]).astype(
        np.int64).tolist())


def _host(x) -> np.ndarray:
    """The values of a small integer input on the host, read once."""
    if isinstance(x, torch.Tensor):
        return np.asarray(x.detach().tolist())
    return np.asarray(x)


def _rows(x, off, key, build):
    """``x`` gathered at the packed rows ``build()`` lists."""
    idx = device_index((key, tuple(off)), x.device,
                       lambda: np.asarray(build(), np.int64))
    return x.index_select(0, idx)


def _col(v, x):
    """A per-sequence vector shaped to broadcast against rows of ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _seg(off, device):
    return device_index(("seg", tuple(off)), device,
                        lambda: _seg_ids(off).astype(np.int64))


def _segment_sum(x, off, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, _seg(off, x.device), x)


def _segment_extreme(x, off, n, reduce):
    """Per-sequence ``amax`` / ``amin`` of rows; an empty sequence gives
    0."""
    seg = _col(_seg(off, x.device), x).expand_as(x)
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.scatter_reduce(0, seg, x, reduce, include_self=False)


# ---------------------------------------------------------------------------
# pooling / softmax
# ---------------------------------------------------------------------------


@register_op("sequence_pool")
def sequence_pool(ctx):
    """SUM, AVERAGE, SQRT, MAX (and ``MaxIndex`` when read), LAST, FIRST
    over each sequence of the finest level; the output carries the outer
    levels.  An empty sequence pools to 0."""
    x = ctx.input("X")
    off = ctx.seq_offsets("X")
    lod = ctx.in_lod("X")
    pooltype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    n = len(off) - 1
    lens = _lengths(off)
    empty = bool((lens == 0).any())
    out_lod = [tuple(tuple(lv) for lv in lod[:-1])] if len(lod) > 1 \
        else [None]

    def lens_dev():
        return _col(device_index(("lens", tuple(off)), x.device,
                                 lambda: lens.astype(np.float32)), x)

    def masked(v):
        if not empty:
            return v
        keep = _col(device_index(("nonempty", tuple(off)), x.device,
                                 lambda: lens > 0), v)
        return torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                                device=v.device))

    maxidx = None
    if pooltype == "SUM":
        out = _segment_sum(x, off, n)
    elif pooltype == "AVERAGE":
        out = _segment_sum(x, off, n) / torch.clamp(lens_dev(), min=1.0)
    elif pooltype == "SQRT":
        out = _segment_sum(x, off, n) / torch.sqrt(
            torch.clamp(lens_dev(), min=1.0))
    elif pooltype == "MAX":
        out = _segment_extreme(x, off, n, "amax")
        if ctx.n_outputs("MaxIndex"):
            seg = _seg(off, x.device)
            pos = _col(torch.arange(x.shape[0], device=x.device), x)
            cand = torch.where(x == out.index_select(0, seg), pos,
                               torch.full_like(pos, x.shape[0] + 1))
            first = _segment_extreme(cand.expand_as(x).contiguous(), off, n,
                                     "amin")
            starts = _col(device_index(
                ("starts", tuple(off)), x.device,
                lambda: np.asarray(off[:-1], np.int64)), x)
            maxidx = masked((first - starts).to(torch.int32))
    elif pooltype in ("LAST", "FIRST"):
        out = masked(_rows(x, off, pooltype, lambda: np.where(
            lens > 0, np.asarray(off[1:]) - 1 if pooltype == "LAST"
            else np.asarray(off[:-1]), 0)))
    else:
        raise ValueError(f"unknown pooltype {pooltype}")
    res = {"Out": out, "Out@LOD": out_lod}
    if maxidx is not None:
        res["MaxIndex"] = maxidx
    return res


@register_op("sequence_softmax")
def sequence_softmax(ctx):
    """Softmax within each sequence."""
    x = ctx.input("X")
    off = ctx.seq_offsets("X")
    n = len(off) - 1
    seg = _seg(off, x.device)
    flat = x.reshape(-1)
    smax = _segment_extreme(flat, off, n, "amax")
    e = torch.exp(flat - smax.index_select(0, seg))
    denom = _segment_sum(e, off, n)
    return {"Out": (e / denom.index_select(0, seg)).reshape(x.shape)}


# ---------------------------------------------------------------------------
# expand / concat / reverse / reshape / slice
# ---------------------------------------------------------------------------


@register_op("sequence_expand", no_grad_inputs=("Y",))
def sequence_expand(ctx):
    """Repeat each sequence of X (each row, without a LoD) as many times
    as Y's LoD at ``ref_level`` says."""
    x = ctx.input("X")
    y_lod = ctx.in_lod("Y")
    ref_level = int(ctx.attr("ref_level", -1))
    if not y_lod:
        raise ValueError("sequence_expand: Y carries no LoD")
    ref = y_lod[ref_level]
    x_lod = ctx.in_lod("X")
    x_off = np.asarray(x_lod[-1]) if x_lod else np.arange(x.shape[0] + 1)
    n_ref = len(ref) - 1
    if len(x_off) - 1 != n_ref:
        raise ValueError(
            f"sequence_expand: X has {len(x_off) - 1} sequences but Y lod "
            f"level {ref_level} has {n_ref}")
    rep = _lengths(ref)
    idx, out_len = [], []
    for i in range(n_ref):
        rows = np.arange(x_off[i], x_off[i + 1])
        for _ in range(int(rep[i])):
            idx.append(rows)
            out_len.append(len(rows))
    flat = np.concatenate(idx) if idx else np.zeros((0,), np.int64)
    out = _rows(x, tuple(ref) + (-1,) + tuple(x_off.tolist()), "expand",
                lambda: flat)
    return {"Out": out, "Out@LOD": [(_cum_offsets(out_len),)]}


@register_op("sequence_expand_as", no_grad_inputs=("Y",))
def sequence_expand_as(ctx):
    """Row i of X repeated as many times as Y's sequence i is long."""
    x = ctx.input("X")
    y_off = ctx.seq_offsets("Y", level=0)
    rep = _lengths(y_off)
    if x.shape[0] != len(rep):
        raise ValueError("sequence_expand_as: X rows != Y sequence count")
    out = _rows(x, y_off, "expand_as",
                lambda: np.repeat(np.arange(x.shape[0]), rep))
    return {"Out": out, "Out@LOD": [(tuple(int(v) for v in y_off),)]}


@register_op("sequence_concat")
def sequence_concat(ctx):
    """Concatenate the j-th sequence of every input."""
    xs = ctx.inputs_list("X")
    offs = [np.asarray(ctx.seq_offsets("X", idx=i)) for i in range(len(xs))]
    n = len(offs[0]) - 1
    if any(len(o) - 1 != n for o in offs):
        raise ValueError("sequence_concat: inputs disagree on sequence count")
    base = np.concatenate([[0], np.cumsum([x.shape[0] for x in xs])])[:-1]
    idx, out_len = [], []
    for j in range(n):
        total = 0
        for i, o in enumerate(offs):
            rows = np.arange(o[j], o[j + 1]) + base[i]
            idx.append(rows)
            total += len(rows)
        out_len.append(total)
    flat = np.concatenate(idx) if idx else np.zeros((0,), np.int64)
    key = tuple(v for o in offs for v in tuple(o.tolist()) + (-1,))
    out = _rows(torch.cat(list(xs), dim=0), key, "concat", lambda: flat)
    return {"Out": out, "Out@LOD": [(_cum_offsets(out_len),)]}


@register_op("sequence_reverse")
def sequence_reverse(ctx):
    """Reverse the rows within each sequence."""
    x = ctx.input("X")
    off = np.asarray(ctx.seq_offsets("X"))

    def build():
        if len(off) < 2:
            return np.zeros((0,), np.int64)
        return np.concatenate([np.arange(off[i + 1] - 1, off[i] - 1, -1)
                               for i in range(len(off) - 1)])

    return {"Y": _rows(x, tuple(off.tolist()), "reverse", build)}


@register_op("sequence_reshape")
def sequence_reshape(ctx):
    """Re-chunk each sequence's flattened data into rows of ``new_dim``."""
    x = ctx.input("X")
    off = np.asarray(ctx.seq_offsets("X"))
    new_dim = int(ctx.attr("new_dim"))
    d = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
    lens = _lengths(off) * d
    if np.any(lens % new_dim):
        raise ValueError("sequence_reshape: sequence bytes not divisible by "
                         f"new_dim={new_dim}")
    return {"Out": x.reshape(-1, new_dim),
            "Out@LOD": [(_cum_offsets(lens // new_dim),)]}


@register_op("sequence_slice", no_grad_inputs=("Offset", "Length"))
def sequence_slice(ctx):
    """Per sequence, rows ``[offset, offset + length)``."""
    x = ctx.input("X")
    off = np.asarray(ctx.seq_offsets("X"))
    o = _host(ctx.input("Offset")).reshape(-1)
    ln = _host(ctx.input("Length")).reshape(-1)
    idx, out_len = [], []
    for i in range(len(off) - 1):
        s = off[i] + int(o[i])
        idx.append(np.arange(s, s + int(ln[i])))
        out_len.append(int(ln[i]))
    flat = np.concatenate(idx) if idx else np.zeros((0,), np.int64)
    key = tuple(off.tolist()) + (-1,) + tuple(int(v) for v in o) + (-1,) \
        + tuple(out_len)
    return {"Out": _rows(x, key, "slice", lambda: flat),
            "Out@LOD": [(_cum_offsets(out_len),)]}


# ---------------------------------------------------------------------------
# pad / unpad / mask / enumerate / lod_reset
# ---------------------------------------------------------------------------


@register_op("sequence_pad", no_grad_inputs=("PadValue",))
def sequence_pad(ctx):
    """Packed -> ``[num_seq, pad_len, ...]`` and ``Length``.  Out keeps
    the input's LoD, so ``sequence_unpad`` restores the packing without
    reading ``Length``."""
    x = ctx.input("X")
    pad_value = ctx.input("PadValue")
    off = np.asarray(ctx.seq_offsets("X"))
    lod = ctx.in_lod("X")
    lens = _lengths(off)
    pad_len = int(ctx.attr("padded_length", -1))
    if pad_len in (-1, 0, None):
        pad_len = int(lens.max()) if len(lens) else 0
    if len(lens) and int(lens.max()) > pad_len:
        raise ValueError(f"padded_length {pad_len} < max sequence length "
                         f"{int(lens.max())}")
    n = len(off) - 1

    def build():
        idx = np.full((n, pad_len), x.shape[0], np.int64)  # the pad row
        for i in range(n):
            idx[i, :lens[i]] = np.arange(off[i], off[i + 1])
        return idx

    idx = device_index(("pad", tuple(off.tolist()), pad_len), x.device,
                       build)
    pv = pad_value.to(dtype=x.dtype, device=x.device)
    pad_row = torch.broadcast_to(pv, tuple(x.shape[1:])).reshape(
        (1,) + tuple(x.shape[1:]))
    xp = torch.cat([x, pad_row], dim=0)
    length = device_index(("lens64", tuple(off.tolist())), x.device,
                          lambda: lens.astype(np.int64))
    return {"Out": xp[idx], "Out@LOD": [lod], "Length": length.clone()}


@register_op("sequence_unpad", no_grad_inputs=("Length",))
def sequence_unpad(ctx):
    """``[num_seq, pad_len, ...]`` and lengths -> packed."""
    x = ctx.input("X")
    lod = ctx.in_lod("X")
    if lod:
        off = np.asarray(lod[-1])
        lens = _lengths(off)
    else:
        lens = _host(ctx.input("Length")).reshape(-1).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(lens)])
    n, pad_len = x.shape[0], x.shape[1]

    def build():
        rows = [np.arange(i * pad_len, i * pad_len + lens[i])
                for i in range(n)]
        return np.concatenate(rows) if rows else np.zeros((0,), np.int64)

    flat = x.reshape((n * pad_len,) + tuple(x.shape[2:]))
    out = _rows(flat, tuple(int(v) for v in off) + (-1, pad_len), "unpad",
                build)
    return {"Out": out, "Out@LOD": [(tuple(int(v) for v in off),)]}


@register_op("sequence_mask", no_grad_inputs=("X",))
def sequence_mask(ctx):
    """Lengths -> a ``[..., maxlen]`` 0/1 mask."""
    from ..fluid import core

    x = ctx.input("X")
    maxlen = int(ctx.attr("maxlen", -1))
    if maxlen < 0:
        maxlen = int(_host(x).max())
    dt = core.torch_dtype(ctx.attr("out_dtype", "int64"))
    mask = torch.arange(maxlen, device=x.device) < x[..., None]
    return {"Y": mask.to(dt)}


@register_op("sequence_enumerate", no_grad_inputs=("X",))
def sequence_enumerate(ctx):
    """Windows of ``win_size`` ids from each position, ``pad_value``
    past the end of its sequence."""
    x = ctx.input("X")
    off = np.asarray(ctx.seq_offsets("X"))
    win = int(ctx.attr("win_size"))
    pad = ctx.attr("pad_value", 0)
    total = x.shape[0]

    def build():
        seg = _seg_ids(off)
        ends = off[seg + 1] if total else np.zeros((0,), np.int64)
        j = np.arange(total)[:, None] + np.arange(win)[None, :]
        return np.where(j < ends[:, None], j, total).astype(np.int64)

    flat = x.reshape(total) if x.dim() > 1 else x
    flatp = torch.cat([flat, torch.full((1,), pad, dtype=flat.dtype,
                                        device=flat.device)])
    idx = device_index(("enumerate", tuple(off.tolist()), win), x.device,
                       build)
    return {"Out": flatp[idx]}


@register_op("lod_reset", no_grad_inputs=("Y",))
def lod_reset(ctx):
    """X with its LoD replaced: Y's LoD, else Y's values as offsets, else
    the ``target_lod`` attr."""
    x = ctx.input("X")
    y = ctx.input("Y")
    if y is not None:
        y_lod = ctx.in_lod("Y")
        if y_lod:
            new = tuple(tuple(int(v) for v in lvl) for lvl in y_lod)
        else:
            new = (tuple(int(v) for v in _host(y).reshape(-1)),)
    else:
        tgt = ctx.attr("target_lod")
        if not tgt:
            raise ValueError("lod_reset: no Y input and empty target_lod")
        new = (tuple(int(v) for v in tgt),)
    if new[-1][-1] != x.shape[0]:
        raise ValueError(f"lod_reset: offsets end {new[-1][-1]} != rows "
                         f"{x.shape[0]}")
    return {"Out": x, "Out@LOD": [new]}


# ---------------------------------------------------------------------------
# sequence_conv / row_conv / sequence_erase
# ---------------------------------------------------------------------------


def _window_index(off, total, start, length, key):
    """``[total, length]`` packed rows ``t + start + k`` that stay inside
    row t's sequence, else ``total`` (a zero row)."""
    def build():
        seg = _seg_ids(off)
        starts = off[seg] if total else np.zeros((0,), np.int64)
        ends = off[seg + 1] if total else np.zeros((0,), np.int64)
        j = np.arange(total)[:, None] + start + np.arange(length)[None, :]
        valid = (j >= starts[:, None]) & (j < ends[:, None])
        return np.where(valid, j, total).astype(np.int64)
    return (key, tuple(off.tolist()), start, length), build


@register_op("sequence_conv", no_grad_inputs=("PaddingData",))
def sequence_conv(ctx):
    """A ``contextLength`` window of rows around each position (zero
    outside its sequence), concatenated, times ``Filter``; without a
    Filter the windowed rows alone (context projection)."""
    x = ctx.input("X")
    filt = ctx.input("Filter") if ctx.has_input("Filter") else None
    off = np.asarray(ctx.seq_offsets("X"))
    ctx_len = int(ctx.attr("contextLength"))
    ctx_start = int(ctx.attr("contextStart", -((ctx_len - 1) // 2)))
    stride = int(ctx.attr("contextStride", 1))
    if stride != 1:
        raise NotImplementedError("sequence_conv: contextStride must be 1 "
                                  "(matches the reference's restriction)")
    total, d = x.shape[0], x.shape[1]
    key, build = _window_index(off, total, ctx_start, ctx_len, "conv")
    idx = device_index(key, x.device, build)
    xp = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    cols = xp[idx].reshape(total, ctx_len * d)
    return {"Out": cols if filt is None else cols @ filt}


@register_op("row_conv")
def row_conv(ctx):
    """Lookahead convolution: ``out[t] = sum_k filter[k] * x[t + k]``
    within each sequence."""
    x = ctx.input("X")
    filt = ctx.input("Filter")  # [future_context_size + 1, D]
    off = np.asarray(ctx.seq_offsets("X"))
    k_len = filt.shape[0]
    total = x.shape[0]
    key, build = _window_index(off, total, 0, k_len, "row_conv")
    idx = device_index(key, x.device, build)
    xp = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype,
                                   device=x.device)])
    out = torch.zeros_like(x)
    for k in range(k_len):
        out = out + xp[idx[:, k]] * filt[k]
    return {"Out": out}


@register_op("sequence_erase", no_grad_inputs=("X",))
def sequence_erase(ctx):
    """Remove the listed token values from each sequence.  The output's
    rows depend on the data: the ids are read on the host."""
    x = ctx.input("X")
    tokens = set(int(t) for t in (ctx.attr("tokens") or []))
    off = ctx.seq_offsets("X")
    if x.numel() == 0:
        return {"Out": x, "Out@LOD": (tuple(int(o) for o in off),)}
    flat = _host(x.reshape(x.shape[0], -1)[:, 0])
    keep = np.array([int(v) not in tokens for v in flat], bool)
    new_off = [0]
    for s, e in zip(off, off[1:]):
        new_off.append(new_off[-1] + int(keep[s:e].sum()))
    idx = torch.as_tensor(np.nonzero(keep)[0], device=x.device)
    return {"Out": x.index_select(0, idx), "Out@LOD": (tuple(new_off),)}


# ---------------------------------------------------------------------------
# lambda_cost (LambdaRank)
# ---------------------------------------------------------------------------


def _lambda_max_dcg(lab_s, k, m):
    """Ideal (max) DCG@k, its zero-relevance-safe divisor, the discounts
    and the gains of one list."""
    dev = lab_s.device
    discounts = 1.0 / torch.log(torch.arange(m, dtype=torch.float32,
                                             device=dev) + 2.0)
    gains = torch.pow(2.0, lab_s) - 1.0
    ideal = torch.sort(gains, descending=True).values
    max_dcg = torch.sum((ideal * discounts)[:k])
    # all-zero relevance: no ranking signal, NDCG 0 and zero lambdas
    safe = torch.where(max_dcg > 0, max_dcg, torch.ones_like(max_dcg))
    return max_dcg, safe, discounts, gains


def _lambda_ndcg(out_s, lab_s, ndcg_num):
    """NDCG@k of one sequence."""
    m = out_s.shape[0]
    k = min(int(ndcg_num), m)
    max_dcg, safe, discounts, gains = _lambda_max_dcg(lab_s, k, m)
    order_by_out = torch.argsort(-out_s, stable=True)
    dcg = torch.sum((gains[order_by_out] * discounts)[:k])
    return torch.where(max_dcg > 0, dcg / safe, torch.zeros_like(dcg))


def _lambda_grads(out_s, lab_s, ndcg_num, sort_size):
    """The lambda pair update of one sequence, over (i < j) pairs in
    label-sorted order."""
    m = out_s.shape[0]
    dev = out_s.device
    k = min(int(ndcg_num), m)
    ss = m if sort_size in (-1, None) else min(int(sort_size), m)
    max_dcg, safe, discounts, _ = _lambda_max_dcg(lab_s, k, m)
    order = torch.argsort(-lab_s, stable=True)
    g = torch.pow(2.0, lab_s[order])          # 2^label, sorted descending
    o = out_s[order]
    dii = discounts[:, None] - discounts[None, :]
    dcg_dif = (g[:, None] - g[None, :]) * dii
    col = torch.arange(m, device=dev)
    if ss < m:
        # pairs whose j falls outside the sorted window use 1/ln(i+2) only
        tail = (g[:, None] - g[None, :]) * discounts[:, None]
        dcg_dif = torch.where(col[None, :] >= ss, tail, dcg_dif)
    lam = -torch.abs(dcg_dif) / (1.0 + torch.exp(o[:, None] - o[None, :]))
    mask = (col[:, None] < ss) & (col[None, :] > col[:, None]) & \
        (max_dcg > 0)
    lam = torch.where(mask, lam, torch.zeros_like(lam)) / safe
    grad_sorted = lam.sum(dim=1) - lam.sum(dim=0)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(m, device=dev)
    return grad_sorted[inv]


@register_op("lambda_cost", no_grad_inputs=("Label",))
def lambda_cost(ctx):
    """LambdaRank: each sequence's NDCG@k on each of its rows; the grad
    is the explicit lambda update below."""
    x = ctx.input("X").reshape(-1)
    lab = ctx.input("Label").reshape(-1).to(torch.float32)
    off = np.asarray(ctx.seq_offsets("X"))
    k = int(ctx.attr("NDCG_num", 5))
    rows = []
    for s, e in zip(off[:-1], off[1:]):
        s, e = int(s), int(e)
        rows.append(_lambda_ndcg(x[s:e], lab[s:e], k).expand(e - s))
    return {"Out": torch.cat(rows).reshape(-1, 1)}


@register_grad("lambda_cost")
def lambda_cost_grad(ctx):
    """The lambda gradients, injected directly (the NDCG's own derivative
    is ignored); each sequence's lambdas scaled by the sum of its rows'
    incoming grads, as the reference scales them."""
    x = ctx.input("X").reshape(-1)
    lab = ctx.input("Label").reshape(-1).to(torch.float32)
    dout = ctx.input("Out@GRAD").reshape(-1)
    off = np.asarray(ctx.seq_offsets("X"))
    k = int(ctx.attr("NDCG_num", 5))
    ss = int(ctx.attr("max_sort_size", -1))
    grads = []
    for s, e in zip(off[:-1], off[1:]):
        s, e = int(s), int(e)
        lam = _lambda_grads(x[s:e], lab[s:e], k, ss)
        grads.append(lam * torch.mean(dout[s:e]) * (e - s))
    return {"X@GRAD": torch.cat(grads).reshape(-1, 1)}


# ---------------------------------------------------------------------------
# sub_nested_seq
# ---------------------------------------------------------------------------


def _sub_nested_gather(ctx):
    """The packed rows of the selected inner sequences, and the output's
    offsets (forward and grad share them)."""
    sel = _host(ctx.input("SelectedIndices")).reshape(-1).astype(np.int64)
    lod = ctx.in_lod("X")
    if not lod or len(lod) < 2:
        raise ValueError("sub_nested_seq: X must be a 2-level nested "
                         "sequence (feed a LoDTensor with lod_level=2)")
    outer, inner = np.asarray(lod[0]), np.asarray(lod[1])
    sel_off = ctx.seq_offsets("SelectedIndices")
    if len(sel_off) - 1 != len(outer) - 1:
        raise ValueError(
            f"sub_nested_seq: SelectedIndices has {len(sel_off) - 1} "
            f"sequences but X has {len(outer) - 1} outer sequences")
    rows, new_off = [], [0]
    for o in range(len(outer) - 1):
        n_inner = int(outer[o + 1] - outer[o])
        for idx in sel[int(sel_off[o]):int(sel_off[o + 1])]:
            if not 0 <= idx < n_inner:
                raise ValueError(
                    f"sub_nested_seq: index {int(idx)} out of range for "
                    f"outer sequence {o} with {n_inner} subsequences")
            g = int(outer[o]) + int(idx)
            s, e = int(inner[g]), int(inner[g + 1])
            rows.append(np.arange(s, e))
            new_off.append(new_off[-1] + (e - s))
    gather = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
    return gather, new_off


@register_op("sub_nested_seq", no_grad_inputs=("SelectedIndices",))
def sub_nested_seq(ctx):
    """Trim a 2-level nested sequence to the inner sequences that
    ``SelectedIndices`` picks for each outer one, in its order: a 1-level
    sequence of the survivors.  The picks are read on the host."""
    x = ctx.input("X")
    gather, new_off = _sub_nested_gather(ctx)
    idx = torch.as_tensor(gather, device=x.device)
    return {"Out": x.index_select(0, idx), "Out@LOD": (tuple(new_off),)}


@register_grad("sub_nested_seq")
def sub_nested_seq_grad(ctx):
    """The output grads added back into the selected rows."""
    x = ctx.input("X")
    dout = ctx.input("Out@GRAD")
    gather, _ = _sub_nested_gather(ctx)
    idx = torch.as_tensor(gather, device=x.device)
    return {"X@GRAD": torch.zeros_like(x).index_add(0, idx,
                                                    dout.to(x.dtype))}
