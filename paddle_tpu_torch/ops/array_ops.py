"""Tensor arrays, the rank table and beam search (counterpart of
``paddle_tpu/ops/array_ops.py``): the substrate of ``DynamicRNN``,
``StaticRNN``, ``IfElse`` and the beam-search decoders.

A tensor array is a plain Python list of tensors (:class:`TensorArray`),
the rank table a host object computed from a LoD (:class:`RankTable`).
Array indices, lengths and counts are host values (numpy, see
``registry.py``): an index is read with no device sync.  The ops that are
data-dependent by nature (split / merge by a mask, the beam ops) read
their device inputs on the host, as the reference does
(``array_ops.py:462-650``); ``beam_search`` copies its candidates to the
host once a step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .registry import register_grad, register_op

# the jit engine's "minus infinity" (``beam_search_jit.py``): a dead lane
NEG_INF = -1.0e30

# copies of device values to the host since the last reset (each a sync)
stats = {"host_copies": 0}


def reset_stats():
    stats["host_copies"] = 0


class TensorArray:
    """A LoDTensorArray value: ``vals`` (tensors, None where unwritten) and
    ``lods`` (each entry's LoD or None).  Writes copy the list (an op never
    changes an array another name still holds)."""

    def __init__(self, vals: Optional[List] = None,
                 lods: Optional[List] = None):
        self.vals: List = list(vals or [])
        self.lods: List = list(lods or [])
        while len(self.lods) < len(self.vals):
            self.lods.append(None)

    def write(self, i: int, val, lod=None):
        while len(self.vals) <= i:
            self.vals.append(None)
            self.lods.append(None)
        self.vals[i] = val
        self.lods[i] = lod

    def read(self, i: int):
        return self.vals[i], self.lods[i]

    def __len__(self):
        return len(self.vals)

    def clone(self) -> "TensorArray":
        return TensorArray(list(self.vals), list(self.lods))

    def __add__(self, other):
        """Entry-wise sum (None-aware): the backward's ``sum`` of two grads
        of one array."""
        if not isinstance(other, TensorArray):
            return NotImplemented
        vals = []
        for i in range(max(len(self.vals), len(other.vals))):
            a = self.vals[i] if i < len(self.vals) else None
            b = other.vals[i] if i < len(other.vals) else None
            vals.append(b if a is None else (a if b is None else a + b))
        lods = self.lods if len(self.lods) >= len(other.lods) else other.lods
        return TensorArray(vals, list(lods))

    __radd__ = __add__


class RankTable:
    """LoDRankTable: (sequence index, length) sorted by length, longest
    first, ties in sequence order."""

    def __init__(self, offsets):
        lens = [int(offsets[i + 1]) - int(offsets[i])
                for i in range(len(offsets) - 1)]
        order = sorted(range(len(lens)), key=lambda i: (-lens[i], i))
        self.items = [(i, lens[i]) for i in order]
        self.offsets = tuple(int(o) for o in offsets)

    @property
    def indices(self):
        return [i for i, _ in self.items]

    @property
    def lengths(self):
        return [n for _, n in self.items]

    def num_active(self, t: int) -> int:
        """How many sequences are still running at step ``t``."""
        return sum(1 for _, n in self.items if n > t)

    def rows(self, t: int) -> List[int]:
        """The packed rows of step ``t``, in the table's order."""
        return [self.offsets[i] + t for i, n in self.items if n > t]


def host_index(v, what: str) -> int:
    """An array index or step as a Python int: a host value is read
    directly, a device tensor costs a sync."""
    if v is None:
        raise RuntimeError(f"{what}: the index is undefined")
    if isinstance(v, torch.Tensor):
        stats["host_copies"] += v.device.type != "cpu"
        return int(v.reshape(-1)[0].item())
    return int(np.asarray(v).reshape(-1)[0])


def _rows(rows, device):
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def _host_mask(ctx):
    return _host(ctx.raw("Mask")).reshape(-1).astype(bool)


# ---------------------------------------------------------------------------
# read / write / length
# ---------------------------------------------------------------------------


@register_op("write_to_array", no_grad_inputs=("I",))
def write_to_array(ctx):
    i = host_index(ctx.raw("I"), "write_to_array")
    arr = ctx.cur_out("Out")
    arr = arr.clone() if isinstance(arr, TensorArray) else TensorArray()
    arr.write(i, ctx.input("X"), ctx.in_lod("X"))
    return {"Out": arr}


@register_grad("write_to_array")
def write_to_array_grad(ctx):
    """d X = (d Out)[i]."""
    i = host_index(ctx.raw("I"), "write_to_array_grad")
    garr = ctx.raw("Out@GRAD")
    if isinstance(garr, TensorArray) and i < len(garr.vals) \
            and garr.vals[i] is not None:
        return {"X@GRAD": garr.vals[i]}
    return {"X@GRAD": torch.zeros_like(ctx.input("X"))}


@register_op("read_from_array", no_grad_inputs=("I",))
def read_from_array(ctx):
    i = host_index(ctx.raw("I"), "read_from_array")
    arr = ctx.raw("X")
    if not isinstance(arr, TensorArray):
        raise TypeError("read_from_array: X is not a tensor array")
    val, lod = arr.read(i)
    return {"Out": val, "Out@LOD": [lod] if lod else [None]}


@register_grad("read_from_array")
def read_from_array_grad(ctx):
    """d X = an array with (d Out) at entry i, zeros elsewhere."""
    i = host_index(ctx.raw("I"), "read_from_array_grad")
    arr = ctx.raw("X")
    g = ctx.raw("Out@GRAD")
    garr = TensorArray(
        [torch.zeros_like(v) if v is not None else None for v in arr.vals],
        list(arr.lods))
    if g is not None:
        garr.write(i, g, arr.lods[i] if i < len(arr.lods) else None)
    return {"X@GRAD": garr}


@register_op("lod_array_length")
def lod_array_length(ctx):
    return {"Out": np.asarray([len(ctx.raw("X"))], np.int64)}


@register_op("is_empty")
def is_empty(ctx):
    """From the array's length or the tensor's shape: a host value, no
    sync."""
    x = ctx.raw("X")
    n = len(x) if isinstance(x, TensorArray) else int(np.prod(x.shape))
    return {"Out": np.asarray([n == 0])}


# ---------------------------------------------------------------------------
# rank table / max len / shrink / reorder
# ---------------------------------------------------------------------------


@register_op("lod_rank_table", no_grad_inputs=("X",))
def lod_rank_table(ctx):
    lod = ctx.in_lod("X")
    if lod:
        offsets = lod[int(ctx.attr("level", 0))]
    else:
        # an input without LoD: every row a sequence of length 1
        offsets = tuple(range(ctx.raw("X").shape[0] + 1))
    return {"Out": RankTable(offsets)}


@register_op("max_sequence_len", no_grad_inputs=("RankTable",))
def max_sequence_len(ctx):
    table = ctx.raw("RankTable")
    return {"Out": np.asarray([table.lengths[0] if table.items else 0],
                              np.int64)}


@register_op("lod_tensor_to_array", no_grad_inputs=("RankTable",))
def lod_tensor_to_array(ctx):
    """Packed X into one batch a time step, the sequences in the rank
    table's order (longest first), so the batch shrinks as steps go."""
    x = ctx.input("X")
    table: RankTable = ctx.raw("RankTable")
    arr = TensorArray()
    for t in range(table.lengths[0] if table.items else 0):
        arr.write(t, x[_rows(table.rows(t), x.device)])
    return {"Out": arr}


@register_grad("lod_tensor_to_array")
def lod_tensor_to_array_grad(ctx):
    x = ctx.input("X")
    table: RankTable = ctx.raw("RankTable")
    garr = ctx.raw("Out@GRAD")
    gx = torch.zeros_like(x)
    if isinstance(garr, TensorArray):
        for t, gv in enumerate(garr.vals):
            if gv is not None:
                gx.index_add_(0, _rows(table.rows(t), x.device),
                              gv.to(gx.dtype))
    return {"X@GRAD": gx}


def _gather_back(table: RankTable, arr: TensorArray):
    """The rows of ``arr``'s entries concatenated, and the map from each
    packed row of the table's LoD to its row there."""
    pieces, rows = [], []
    for t, v in enumerate(arr.vals):
        if v is None:
            continue
        pieces.append(v)
        rows.extend(table.rows(t))
    inv = np.empty((table.offsets[-1],), np.int64)
    inv[np.asarray(rows, np.int64)] = np.arange(len(rows))
    return torch.cat(pieces, 0), inv


@register_op("array_to_lod_tensor", no_grad_inputs=("RankTable",))
def array_to_lod_tensor(ctx):
    """The inverse of ``lod_tensor_to_array``: the step batches back into
    packed rows with the table's LoD."""
    arr: TensorArray = ctx.raw("X")
    table: RankTable = ctx.raw("RankTable")
    cat, inv = _gather_back(table, arr)
    return {"Out": cat[_rows(inv, cat.device)],
            "Out@LOD": [(table.offsets,)]}


@register_grad("array_to_lod_tensor")
def array_to_lod_tensor_grad(ctx):
    arr: TensorArray = ctx.raw("X")
    table: RankTable = ctx.raw("RankTable")
    g = ctx.input("Out@GRAD")
    garr = TensorArray()
    for t, v in enumerate(arr.vals):
        if v is not None:
            garr.write(t, g[_rows(table.rows(t), g.device)])
    return {"X@GRAD": garr}


@register_op("shrink_rnn_memory", no_grad_inputs=("I", "RankTable"))
def shrink_rnn_memory(ctx):
    """X's rows cut to the batch still running at step I."""
    i = host_index(ctx.raw("I"), "shrink_rnn_memory")
    return {"Out": ctx.input("X")[:ctx.raw("RankTable").num_active(i)]}


@register_grad("shrink_rnn_memory")
def shrink_rnn_memory_grad(ctx):
    x = ctx.input("X")
    g = ctx.input("Out@GRAD")
    gx = torch.zeros_like(x)
    gx[:g.shape[0]] = g.to(x.dtype)
    return {"X@GRAD": gx}


@register_op("reorder_lod_tensor_by_rank", no_grad_inputs=("RankTable",))
def reorder_lod_tensor_by_rank(ctx):
    """X's sequences (or rows, without a LoD) in the rank table's
    order."""
    x = ctx.input("X")
    table: RankTable = ctx.raw("RankTable")
    lod = ctx.in_lod("X")
    if lod:
        off = lod[-1]
        rows, lens = [], []
        for i in table.indices:
            rows.extend(range(off[i], off[i + 1]))
            lens.append(off[i + 1] - off[i])
        out_lod = (tuple(int(o) for o in np.concatenate(
            [[0], np.cumsum(lens)])),)
        return {"Out": x[_rows(rows, x.device)], "Out@LOD": [out_lod]}
    return {"Out": x[_rows(table.indices, x.device)]}


# ---------------------------------------------------------------------------
# a leading time axis <-> an array: StaticRNN's substrate
# ---------------------------------------------------------------------------


@register_op("tensor_array_unstack")
def tensor_array_unstack(ctx):
    x = ctx.input("X")
    return {"Out": TensorArray([x[t] for t in range(x.shape[0])])}


@register_grad("tensor_array_unstack")
def tensor_array_unstack_grad(ctx):
    x = ctx.input("X")
    garr = ctx.raw("Out@GRAD")
    vals = []
    for t in range(x.shape[0]):
        g = garr.vals[t] if isinstance(garr, TensorArray) and \
            t < len(garr.vals) else None
        vals.append(torch.zeros_like(x[t]) if g is None else g.to(x.dtype))
    return {"X@GRAD": torch.stack(vals)}


@register_op("tensor_array_stack")
def tensor_array_stack(ctx):
    return {"Out": torch.stack([v for v in ctx.raw("X").vals
                                if v is not None])}


@register_grad("tensor_array_stack")
def tensor_array_stack_grad(ctx):
    arr: TensorArray = ctx.raw("X")
    g = ctx.input("Out@GRAD")
    garr, j = TensorArray(), 0
    for t, v in enumerate(arr.vals):
        if v is not None:
            garr.write(t, g[j])
            j += 1
    return {"X@GRAD": garr}


# ---------------------------------------------------------------------------
# IfElse's substrate: split and merge rows by a mask (the mask is read on
# the host)
# ---------------------------------------------------------------------------


@register_op("split_lod_tensor", no_grad_inputs=("Mask",))
def split_lod_tensor(ctx):
    x = ctx.input("X")
    mask = _host_mask(ctx)
    lod = ctx.in_lod("X")
    if int(ctx.attr("level", 0)) != 0:
        raise NotImplementedError(
            "split_lod_tensor: only level=0 splits are supported.")
    if lod and np.any(np.diff(np.asarray(lod[-1])) != 1):
        raise NotImplementedError(
            "split_lod_tensor: sequence-level split of multi-row LoD "
            "sequences is not supported; only row-wise split where each "
            "sequence is one row. Ref: split_lod_tensor_op.cc.")
    if mask.shape[0] != x.shape[0]:
        raise ValueError(
            f"split_lod_tensor: mask length {mask.shape[0]} != input rows "
            f"{x.shape[0]}")
    return {"OutTrue": x[_rows(np.nonzero(mask)[0], x.device)],
            "OutFalse": x[_rows(np.nonzero(~mask)[0], x.device)]}


@register_grad("split_lod_tensor")
def split_lod_tensor_grad(ctx):
    x = ctx.input("X")
    mask = _host_mask(ctx)
    gx = torch.zeros_like(x)
    for g, sel in ((ctx.input("OutTrue@GRAD"), mask),
                   (ctx.input("OutFalse@GRAD"), ~mask)):
        if g is not None:
            gx.index_add_(0, _rows(np.nonzero(sel)[0], x.device),
                          g.to(x.dtype))
    return {"X@GRAD": gx}


@register_op("merge_lod_tensor", no_grad_inputs=("Mask", "X"))
def merge_lod_tensor(ctx):
    mask = _host_mask(ctx)
    in_true, in_false = ctx.input("InTrue"), ctx.input("InFalse")
    if int(ctx.attr("level", 0)) != 0:
        raise NotImplementedError(
            "merge_lod_tensor: only level=0 row-wise merge is supported.")
    n_rows = in_true.shape[0] + in_false.shape[0]
    if mask.shape[0] != n_rows:
        raise ValueError(
            f"merge_lod_tensor: mask length {mask.shape[0]} != total rows "
            f"{n_rows}")
    out = in_true.new_zeros((len(mask),) + tuple(in_true.shape[1:]))
    out = out.index_copy(0, _rows(np.nonzero(mask)[0], out.device), in_true)
    out = out.index_copy(0, _rows(np.nonzero(~mask)[0], out.device),
                         in_false.to(out.dtype))
    return {"Out": out}


@register_grad("merge_lod_tensor")
def merge_lod_tensor_grad(ctx):
    mask = _host_mask(ctx)
    g = ctx.input("Out@GRAD")
    return {"InTrue@GRAD": g[_rows(np.nonzero(mask)[0], g.device)],
            "InFalse@GRAD": g[_rows(np.nonzero(~mask)[0], g.device)]}


# ---------------------------------------------------------------------------
# beam search (host)
# ---------------------------------------------------------------------------


def _host(v):
    """A tensor's values as numpy (from the card, a copy to the host)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        stats["host_copies"] += v.device.type != "cpu"
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _hypotheses(groups):
    """The 2-level-LoD (SentenceIds, SentenceScores) pair of per-source
    hypothesis lists ``[(final score, ids, scores)]``."""
    flat_ids = [t for g in groups for _, h, _ in g for t in h]
    flat_sc = [s for g in groups for _, _, hs in g for s in hs]
    lens = [len(h) for g in groups for _, h, _ in g]
    off = tuple(int(o) for o in np.concatenate([[0], np.cumsum(lens)]))
    src = tuple(int(o) for o in np.concatenate(
        [[0], np.cumsum([len(g) for g in groups])]))
    lod = (src, off)
    return {"SentenceIds": torch.from_numpy(
                np.asarray(flat_ids, np.int64).reshape(-1, 1)),
            "SentenceScores": torch.from_numpy(
                np.asarray(flat_sc, np.float32).reshape(-1, 1)),
            "SentenceIds@LOD": [lod], "SentenceScores@LOD": [lod]}


def _on(outs, device):
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in outs.items()}


@register_op("beam_search", no_grad_inputs=("pre_ids", "ids", "scores"))
def beam_search(ctx):
    """One beam-search step, fixed width: an ended beam (its pre_id is
    end_id) keeps one candidate, end_id at its frozen score.  pre_ids
    [batch*beam, 1], ids / scores [batch*beam, K] candidates; selected_ids
    / selected_scores [n, 1] with a 2-level LoD: level 0 the selections of
    each source, level 1 those of each parent row (rows grouped by
    parent).  The candidates come to the host: one copy of each input a
    step."""
    pre_ids = _host(ctx.raw("pre_ids"))
    pre_scores = _host(ctx.raw("pre_scores"))
    scores = _host(ctx.raw("scores"))
    ids = _host(ctx.raw("ids"))
    beam_size = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    lod = ctx.in_lod("ids") or ctx.in_lod("scores")
    if lod:
        src_off = lod[0]
    else:
        n_src = max(1, pre_ids.shape[0] // beam_size)
        src_off = tuple(np.arange(n_src + 1) * beam_size)

    sel_ids, sel_scores, parents = [], [], []
    out_off = [0]
    for s in range(len(src_off) - 1):
        cand = []  # (score, id, parent row)
        for row in range(int(src_off[s]), int(src_off[s + 1])):
            if int(pre_ids[row, 0]) == end_id:
                frozen = float(pre_scores[row].reshape(-1)[0]) \
                    if pre_scores is not None else float(scores[row].max())
                cand.append((frozen, end_id, row))
                continue
            for k in range(scores.shape[1]):
                cid = int(ids[row, k]) if ids is not None else k
                cand.append((float(scores[row, k]), cid, row))
        cand.sort(key=lambda c: -c[0])
        # best first, then grouped by parent row (stable)
        top = sorted(cand[:beam_size], key=lambda c: c[2])
        for sc, cid, prow in top:
            sel_ids.append(cid)
            sel_scores.append(sc)
            parents.append(prow)
        out_off.append(out_off[-1] + len(top))

    counts = np.zeros((pre_ids.shape[0],), np.int64)
    for p in parents:
        counts[p] += 1
    par_off = np.concatenate([[0], np.cumsum(counts)])
    lod_out = (tuple(int(o) for o in out_off),
               tuple(int(o) for o in par_off))
    out = {"selected_ids": torch.from_numpy(
               np.asarray(sel_ids, np.int64).reshape(-1, 1)),
           "selected_scores": torch.from_numpy(
               np.asarray(sel_scores, np.float32).reshape(-1, 1)),
           "selected_ids@LOD": [lod_out], "selected_scores@LOD": [lod_out]}
    if ctx.n_outputs("parent_idx"):
        out["parent_idx"] = torch.from_numpy(np.asarray(parents, np.int64))
    return _on(out, ctx.device)


@register_op("beam_search_decode", no_grad_inputs=("Ids", "Scores"))
def beam_search_decode(ctx):
    """Backtrack whole hypotheses from the step arrays (level 1 of each
    step's LoD maps a selected row to its parent row); each source's
    hypotheses best first, each cut after its first end_id, with the
    score of every step along the chain."""
    ids_arr: TensorArray = ctx.raw("Ids")
    scores_arr: TensorArray = ctx.raw("Scores")
    end_id = int(ctx.attr("end_id", -1))
    steps = [(_host(ids_arr.vals[t]).reshape(-1),
              _host(scores_arr.vals[t]).reshape(-1), ids_arr.lods[t])
             for t in range(len(ids_arr.vals))]
    n_final = len(steps[-1][0]) if steps else 0
    final_lod = steps[-1][2] if steps else None
    if final_lod and len(final_lod) >= 1 and len(final_lod[0]) > 1:
        src_off = [int(o) for o in final_lod[0]]
    else:
        src_off = [0, n_final]

    groups = []
    for s in range(len(src_off) - 1):
        group = []
        for j in range(src_off[s], src_off[s + 1]):
            chain, chain_sc, row = [], [], j
            for t in range(len(steps) - 1, -1, -1):
                ids_t, sc_t, lod_t = steps[t]
                chain.append(int(ids_t[row]))
                chain_sc.append(float(sc_t[row]))
                if lod_t and len(lod_t) > 1:
                    row = int(np.searchsorted(np.asarray(lod_t[1]), row,
                                              side="right") - 1)
            chain.reverse()
            chain_sc.reverse()
            if end_id >= 0 and end_id in chain:
                k = chain.index(end_id) + 1
                chain, chain_sc = chain[:k], chain_sc[:k]
            group.append((float(steps[-1][1][j]), chain, chain_sc))
        group.sort(key=lambda g: -g[0])
        groups.append(group)
    return _on(_hypotheses(groups), ctx.device)


@register_op("beam_search_pack",
             no_grad_inputs=("HistIds", "HistParents", "HistScores",
                             "NumSteps"))
def beam_search_pack(ctx):
    """The jit engine's boundary op (``beam_search_jit.py``): its dense
    [n_steps, batch, beam] histories into ``beam_search_decode``'s 2-level
    LoD pair (chains backtracked, cut after the first end_id, each
    source's best first; a dead lane dropped).  One copy of the histories
    to the host."""
    h_ids = _host(ctx.raw("HistIds"))
    h_par = _host(ctx.raw("HistParents"))
    h_sc = _host(ctx.raw("HistScores"))
    n = host_index(ctx.raw("NumSteps"), "beam_search_pack")
    end_id = int(ctx.attr("end_id"))
    _, batch, beam = h_ids.shape
    groups = []
    for b in range(batch):
        group = []
        for k in range(beam):
            chain, chain_sc, row = [], [], k
            for t in range(n - 1, -1, -1):
                chain.append(int(h_ids[t, b, row]))
                chain_sc.append(float(h_sc[t, b, row]))
                if t > 0:
                    row = int(h_par[t, b, row])
            chain.reverse()
            chain_sc.reverse()
            final = chain_sc[-1]
            if final <= NEG_INF / 2:
                continue
            if end_id in chain:
                cut = chain.index(end_id) + 1
                chain, chain_sc = chain[:cut], chain_sc[:cut]
            group.append((final, chain, chain_sc))
        group.sort(key=lambda g: -g[0])
        groups.append(group)
    return _on(_hypotheses(groups), ctx.device)
