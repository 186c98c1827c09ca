"""Structured losses (counterpart of ``paddle_tpu/ops/struct_loss_ops.py``):
linear-chain CRF, Viterbi decoding, CTC (warpctc), NCE, hierarchical
sigmoid, and the metric ops edit distance, chunk evaluation and CTC
alignment.

The dynamic programs (the CRF's forward algorithm, Viterbi, the CTC
alpha) run in log space over the padded time-major ``[T, S, ...]`` batch
that ``rnn_ops`` builds from the LoD on the host and caches on the device
(``rnn_ops._padding``), as a loop over time whose steps carry a finished
sequence's state on.  The reference's ``lax.scan`` is outside any Pallas
kernel, so this is plain PyTorch; the grads of the CRF and the CTC come
from the generic grad (the reference's ``jax.vjp``).  ``NEG`` is the
reference's ``-1e30`` sentinel, not ``-inf``: ``NEG + NEG`` stays finite
in fp32 and both packages round it alike.

``edit_distance``, ``chunk_eval`` and ``ctc_align`` are host ops
(``registry.EAGER_OPS``): each reads its inputs back once (one transfer,
counted in :data:`stats` when it comes off the card) and returns its
outputs as tensors on the input's device, so an evaluator's accumulation
ops stay on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_grad, register_op
from .rnn_ops import _padding
from .sequence_ops import device_index

NEG = -1e30

# device-to-host reads made by the host ops (``reset_stats`` zeroes them)
stats = {"host_reads": 0}


def reset_stats():
    stats["host_reads"] = 0


def _read_back(*tensors) -> list:
    """The values of integer tensors on the host, as one flat list per
    tensor, in one transfer."""
    flat = [t.reshape(-1) for t in tensors]
    if flat[0].device.type != "cpu":
        stats["host_reads"] += 1
    vals = torch.cat([f.to(torch.int64) for f in flat]).tolist() \
        if len(flat) > 1 else flat[0].tolist()
    out, k = [], 0
    for f in flat:
        out.append(vals[k:k + f.numel()])
        k += f.numel()
    return out


def _mask(pad, dtype):
    """The ``[T, S]`` validity of a padding as ``dtype`` (None when every
    sequence is ``T`` long)."""
    return None if pad.full else pad.mask[..., 0].to(dtype)


def _lens(off):
    off = np.asarray(off, np.int64)
    return off[1:] - off[:-1]


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------


@register_op("linear_chain_crf", no_grad_inputs=("Label",))
def linear_chain_crf(ctx):
    """``Transition`` rows are ``[start; end; A]``.  ``LogLikelihood`` is
    the NEGATIVE log-likelihood of each sequence, ``[S, 1]``, with no LoD;
    ``Alpha`` the log-space forward variables in the LoD's rows;
    ``EmissionExps`` / ``TransitionExps`` are made only when read."""
    emission = ctx.input("Emission")       # [N, K] packed
    transition = ctx.input("Transition")   # [K+2, K]
    label = ctx.input("Label")             # [N, 1] int
    off = ctx.seq_offsets("Emission")
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    pad = _padding(off, False, emission.device)
    em = pad.pad(emission)                                   # [T, S, K]
    lab = pad.pad(label.reshape(-1, 1).long())[..., 0]       # [T, S]
    mask = _mask(pad, em.dtype)

    alpha = start_w[None, :] + em[0]
    alphas = [alpha]
    for t in range(1, pad.t_max):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :], dim=1)
        new = em[t] + nxt
        alpha = pad.carry(t, new, alpha)
        alphas.append(new)
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=1)

    # the gold path's score; its last label sits at lens - 1
    cols = device_index(("crf_cols", len(off) - 1), em.device,
                        lambda: np.arange(len(off) - 1))
    last_t = device_index(("crf_last", tuple(off)), em.device,
                          lambda: np.maximum(_lens(off) - 1, 0))
    em_gold = em.gather(2, lab[:, :, None])[..., 0]          # [T, S]
    if mask is not None:
        em_gold = em_gold * mask
    gold = start_w[lab[0]] + em_gold.sum(0)
    if pad.t_max > 1:
        tr_gold = trans[lab[:-1], lab[1:]]                   # [T-1, S]
        if mask is not None:
            tr_gold = tr_gold * mask[1:]
        gold = gold + tr_gold.sum(0)
    gold = gold + end_w[lab[last_t, cols]]

    res = {"LogLikelihood": (log_z - gold).reshape(-1, 1),
           "LogLikelihood@LOD": [None]}
    if ctx.n_outputs("Alpha"):
        res["Alpha"] = pad.pack(alphas)
    if ctx.n_outputs("EmissionExps"):
        res["EmissionExps"] = torch.exp(emission)
    if ctx.n_outputs("TransitionExps"):
        res["TransitionExps"] = torch.exp(transition)
    return res


@register_op("crf_decoding", no_grad_inputs=("Emission", "Transition",
                                             "Label"))
def crf_decoding(ctx):
    """Viterbi: the best previous tag of each step kept on the device,
    then a backtrack by gathers on the device.  ``ViterbiPath`` is int64
    ``[N, 1]`` with the emission's LoD; with ``Label``, 1 where the path
    equals it and 0 elsewhere."""
    emission = ctx.input("Emission")
    transition = ctx.input("Transition")
    label = ctx.input("Label")
    off = ctx.seq_offsets("Emission")
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    pad = _padding(off, False, emission.device)
    em = pad.pad(emission)

    alpha = start_w[None, :] + em[0]
    back = []
    for t in range(1, pad.t_max):
        cand = alpha[:, :, None] + trans[None, :, :]           # [S, K, K]
        best_prev = torch.argmax(cand, dim=1)
        new = em[t] + cand.gather(1, best_prev[:, None, :])[:, 0, :]
        alpha = pad.carry(t, new, alpha)
        back.append(best_prev)

    # past a sequence's end ``cur`` keeps its own best last tag until the
    # backtrack reaches that sequence's last step
    cur = torch.argmax(alpha + end_w[None, :], dim=1)
    tags = [None] * pad.t_max
    for t in range(pad.t_max - 1, 0, -1):
        tags[t] = cur
        prev = back[t - 1].gather(1, cur[:, None])[:, 0]
        cur = prev if pad.full else torch.where(pad.mask[t, :, 0], prev, cur)
    tags[0] = cur
    path = pad.pack([t[:, None] for t in tags]).reshape(-1, 1).long()
    if label is not None:
        return {"ViterbiPath": (path == label.reshape(-1, 1).long()).long()}
    return {"ViterbiPath": path}


# ---------------------------------------------------------------------------
# CTC (warpctc)
# ---------------------------------------------------------------------------


def _ctc_loss(logits, label, log_off, lab_off, blank, norm_by_times):
    """``[S, 1]`` CTC loss: the log-space alpha over the blank-interleaved
    label ``l' = [blank, y1, blank, ..., yL, blank]``."""
    dev = logits.device
    l_lens = _lens(lab_off)
    n_seq = len(l_lens)
    l_max = int(l_lens.max()) if n_seq else 0
    s_len = 2 * l_max + 1
    pad = _padding(log_off, False, dev)
    lp = pad.pad(torch.log_softmax(logits, dim=-1))         # [T, S, C]
    lab = _padding(lab_off, False, dev).pad(
        label.reshape(-1, 1).long())[..., 0].t()            # [S, L]
    ext = torch.full((n_seq, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    key = tuple(int(v) for v in lab_off)
    ext_valid = device_index(
        ("ctc_valid", key, s_len), dev,
        lambda: np.arange(s_len)[None, :] < (2 * l_lens + 1)[:, None])
    skip_ok = torch.zeros((n_seq, s_len), dtype=torch.bool, device=dev)
    if s_len > 2:
        skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((n_seq, s_len + 1), NEG, dtype=lp.dtype, device=dev)

    # at frame 0 only l'[0] (a blank) and l'[1] (the first label) start
    e0 = lp[0].gather(1, ext)
    alpha = torch.cat([e0[:, :1], torch.where(ext_valid[:, 1:2], e0[:, 1:2],
                                              NEG), neg[:, 3:]], dim=1) \
        if s_len > 1 else e0
    for t in range(1, pad.t_max):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1)[:, :s_len]
        prev2 = torch.where(skip_ok, prev2, NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(ext_valid, merged + lp[t].gather(1, ext), NEG)
        alpha = pad.carry(t, new, alpha)

    # loss = -log(alpha[2L] + alpha[2L - 1]) at each sequence's last frame
    last_s = device_index(("ctc_last", key), dev, lambda: 2 * l_lens)
    a_end = alpha.gather(1, last_s[:, None])[:, 0]
    a_end1 = alpha.gather(1, (last_s - 1).clamp_min(0)[:, None])[:, 0]
    has_label = device_index(("ctc_has", key), dev, lambda: l_lens > 0)
    loss = -torch.logaddexp(a_end, torch.where(has_label, a_end1, NEG))
    if norm_by_times:
        t_lens = device_index(("ctc_t", tuple(int(v) for v in log_off)), dev,
                              lambda: _lens(log_off))
        loss = loss / t_lens.to(loss.dtype)
    return loss.reshape(-1, 1).to(logits.dtype)


@register_op("warpctc", no_grad_inputs=("Label",))
def warpctc(ctx):
    """CTC loss of packed (LoD) unnormalized ``Logits`` against packed
    ``Label`` ids: ``Loss`` ``[S, 1]`` with no LoD; ``WarpCTCGrad`` (the
    grad of the summed loss in the logits) only when read.  A sequence
    with fewer frames than labels raises, as in the reference."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    blank = int(ctx.attr("blank", 0))
    norm_by_times = bool(ctx.attr("norm_by_times", False))
    log_off = ctx.seq_offsets("Logits")
    lab_off = ctx.seq_offsets("Label")
    t_lens, l_lens = _lens(log_off), _lens(lab_off)
    for i in range(len(t_lens)):
        if t_lens[i] < l_lens[i]:
            raise ValueError(
                f"warpctc: sequence {i} has {int(t_lens[i])} frames but "
                f"{int(l_lens[i])} labels — no CTC alignment exists")
    if not ctx.n_outputs("WarpCTCGrad"):
        return {"Loss": _ctc_loss(logits, label, log_off, lab_off, blank,
                                  norm_by_times), "Loss@LOD": [None]}
    with torch.enable_grad():
        leaf = logits.detach().requires_grad_()
        loss = _ctc_loss(leaf, label, log_off, lab_off, blank, norm_by_times)
        (grad,) = torch.autograd.grad(loss.sum(), leaf)
    return {"Loss": loss.detach(), "Loss@LOD": [None], "WarpCTCGrad": grad}


# ---------------------------------------------------------------------------
# NCE / hierarchical sigmoid
# ---------------------------------------------------------------------------


def _nce_cost(x, weight, bias, label, samples, k, num_classes):
    """The NCE objective ``[B]`` for fixed noise samples, with the true and
    the noise logits."""
    num_true = label.shape[1]

    def logits_for(ids):
        out = torch.einsum("bd,bnd->bn", x, weight[ids])
        if bias is not None:
            out = out + bias.reshape(-1)[ids]
        return out

    log_kq = float(np.log(float(k) / num_classes))
    true_lg = logits_for(label) - log_kq
    noise_lg = logits_for(samples) - log_kq
    cost = F.softplus(-true_lg).sum(1) / num_true \
        + F.softplus(noise_lg).sum(1)
    return cost, true_lg, noise_lg


def _nce_label(ctx, b):
    label = ctx.input("Label").long()
    return label.reshape(b, label.shape[1] if label.dim() > 1 else 1)


@register_op("nce", no_grad_inputs=("Label", "SampleWeight"), stateful=True)
def nce(ctx):
    """Noise-contrastive estimation with a uniform sampler.  The negatives:
    ``custom_neg_classes`` when given; else, with a nonzero ``seed``, one
    fixed draw from a ``torch.Generator`` seeded with it (fixed across
    runs, as in the reference, with other values than its threefry
    draw); else fresh from the executor's generator each step.  The grad
    op replays the objective with the ``SampleLabels`` drawn here."""
    x = ctx.input("Input")                 # [B, D]
    weight = ctx.input("Weight")           # [C, D]
    bias = ctx.input("Bias")               # [C] or [C, 1]
    num_classes = int(ctx.attr("num_total_classes"))
    k = int(ctx.attr("num_neg_samples", 10))
    b = x.shape[0]
    label = _nce_label(ctx, b)
    custom = ctx.attr("custom_neg_classes") or []
    seed = int(ctx.attr("seed", 0))
    if custom:
        k = len(custom)
        samples = torch.as_tensor(np.asarray(custom, np.int64),
                                  device=x.device)[None, :].expand(b, k)
    elif seed != 0:
        gen = torch.Generator().manual_seed(seed)
        samples = torch.randint(0, num_classes, (b, k), generator=gen).to(
            x.device)
    else:
        samples = torch.randint(0, num_classes, (b, k), device=x.device,
                                generator=ctx.generator)
    cost, true_lg, noise_lg = _nce_cost(x, weight, bias, label, samples, k,
                                        num_classes)
    return {"Cost": cost.reshape(-1, 1),
            "SampleLogits": torch.cat([true_lg, noise_lg], dim=1),
            "SampleLabels": torch.cat([label, samples], dim=1)}


@register_grad("nce")
def nce_grad(ctx):
    """The grad of the objective with the forward's drawn samples (read
    from its ``SampleLabels``)."""
    x = ctx.input("Input")
    weight = ctx.input("Weight")
    bias = ctx.input("Bias")
    num_classes = int(ctx.attr("num_total_classes"))
    label = _nce_label(ctx, x.shape[0])
    samples = ctx.input("SampleLabels")[:, label.shape[1]:]
    cot = ctx.input("Cost@GRAD").reshape(-1).to(x.dtype)
    leaves = [v.detach().requires_grad_() for v in (x, weight)
              + ((bias,) if bias is not None else ())]
    with torch.enable_grad():
        cost = _nce_cost(leaves[0], leaves[1],
                         leaves[2] if bias is not None else None, label,
                         samples, samples.shape[1], num_classes)[0]
        grads = torch.autograd.grad(cost, leaves, cot)
    out = {"Input@GRAD": grads[0], "Weight@GRAD": grads[1]}
    if bias is not None:
        out["Bias@GRAD"] = grads[2]
    return out


@register_op("hierarchical_sigmoid", no_grad_inputs=("Label",))
def hierarchical_sigmoid(ctx):
    """The complete binary tree over classes: ``code = label +
    num_classes``, node ``(code >> (d + 1)) - 1`` and bit ``(code >> d) &
    1`` at depth d.  ``PreOut`` (the node logits) only when read."""
    x = ctx.input("X")                     # [B, D]
    w = ctx.input("W")                     # [C-1, D]
    bias = ctx.input("Bias")               # [1, C-1]
    num_classes = int(ctx.attr("num_classes"))
    code = ctx.input("Label").reshape(-1).long() + num_classes
    total, pre_out = 0.0, []
    for d in range(int(np.floor(np.log2(num_classes))) + 1):
        node = (code >> (d + 1)) - 1
        valid = node >= 0
        bit = ((code >> d) & 1).to(x.dtype)
        node_c = node.clamp_min(0)
        logit = (x * w[node_c]).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[node_c]
        loss_d = F.softplus(logit) - bit * logit
        total = total + torch.where(valid, loss_d, torch.zeros_like(loss_d))
        pre_out.append(torch.where(valid, logit, torch.zeros_like(logit)))
    res = {"Out": total.reshape(-1, 1)}
    if ctx.n_outputs("PreOut"):
        res["PreOut"] = torch.stack(pre_out, dim=1)
    return res


# ---------------------------------------------------------------------------
# edit distance / chunk eval / ctc align (host ops)
# ---------------------------------------------------------------------------


def _levenshtein(h, r) -> int:
    dp = list(range(len(r) + 1))
    for a in range(1, len(h) + 1):
        prev, dp[0] = dp[:], a
        for j in range(1, len(r) + 1):
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                        prev[j - 1] + (h[a - 1] != r[j - 1]))
    return dp[len(r)]


@register_op("edit_distance", no_grad_inputs=("Hyps", "Refs"))
def edit_distance(ctx):
    """Levenshtein distance of each (hypothesis, reference) pair, ``[S,
    1]`` float32 (over the reference's length with ``normalized``), and
    ``SequenceNum`` int64 ``[1]``."""
    hyps, refs = ctx.input("Hyps"), ctx.input("Refs")
    h_off, r_off = ctx.seq_offsets("Hyps"), ctx.seq_offsets("Refs")
    normalized = bool(ctx.attr("normalized", False))
    h, r = _read_back(hyps, refs)
    n = len(h_off) - 1
    out = np.zeros((n, 1), np.float32)
    for i in range(n):
        ref = r[r_off[i]:r_off[i + 1]]
        d = float(_levenshtein(h[h_off[i]:h_off[i + 1]], ref))
        out[i, 0] = d / max(len(ref), 1) if normalized else d
    return {"Out": torch.as_tensor(out, device=hyps.device),
            "SequenceNum": torch.full((1,), n, dtype=torch.int64,
                                      device=hyps.device)}


_SCHEME_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _extract_chunks(tags, scheme, num_types):
    """The ``(type, begin, end)`` chunks of a tag sequence.  Tag layout:
    ``IOB`` type*2 + {0: B, 1: I}; ``IOE`` type*2 + {0: I, 1: E};
    ``IOBES`` type*4 + {B, I, E, S}; ``plain`` the type.  A tag at or past
    ``num_types`` times the tags a type is "other"."""
    chunks = []
    cur_type, cur_start = None, None

    def flush(end):
        nonlocal cur_type, cur_start
        if cur_type is not None:
            chunks.append((cur_type, cur_start, end))
            cur_type, cur_start = None, None

    n_tag = _SCHEME_TAGS[scheme]
    for i, t in enumerate(tags):
        t = int(t)
        if t >= num_types * n_tag:
            flush(i)
            continue
        ty, pos = divmod(t, n_tag)
        if scheme == "plain":
            if cur_type != ty:
                flush(i)
                cur_type, cur_start = ty, i
        elif scheme == "IOB":
            if pos == 0 or cur_type != ty:      # B, or an I that starts
                flush(i)
                cur_type, cur_start = ty, i
        elif scheme == "IOE":
            if cur_type != ty:
                flush(i)
                cur_type, cur_start = ty, i
            if pos == 1:                        # E closes the chunk
                flush(i + 1)
        elif pos == 0 or (pos == 1 and cur_type != ty):   # IOBES: B, I
            flush(i)
            cur_type, cur_start = ty, i
        elif pos == 2:                          # E
            if cur_type != ty:
                cur_type, cur_start = ty, i
            flush(i + 1)
        elif pos == 3:                          # S
            flush(i)
            chunks.append((ty, i, i + 1))
    flush(len(tags))
    return set(chunks)


@register_op("chunk_eval", no_grad_inputs=("Inference", "Label"))
def chunk_eval(ctx):
    """Precision, recall and F1 (float32 ``[1]``) over the chunks of each
    sequence, and the int64 ``[1]`` counts of inferred, labelled and
    correct chunks; ``excluded_chunk_types`` are left out."""
    inf, lab = ctx.input("Inference"), ctx.input("Label")
    off = ctx.seq_offsets("Inference")
    num_types = int(ctx.attr("num_chunk_types"))
    scheme = str(ctx.attr("chunk_scheme", "IOB"))
    excluded = set(ctx.attr("excluded_chunk_types") or [])
    inf_v, lab_v = _read_back(inf, lab)
    n_inf = n_lab = n_correct = 0
    for i in range(len(off) - 1):
        ci, cl = ({c for c in _extract_chunks(v[off[i]:off[i + 1]], scheme,
                                              num_types)
                   if c[0] not in excluded} for v in (inf_v, lab_v))
        n_inf += len(ci)
        n_lab += len(cl)
        n_correct += len(ci & cl)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0

    def fill(v, dtype):
        # a fill, not a copy from the host
        return torch.full((1,), v, dtype=dtype, device=inf.device)

    return {"Precision": fill(p, torch.float32),
            "Recall": fill(r, torch.float32),
            "F1-Score": fill(f1, torch.float32),
            "NumInferChunks": fill(n_inf, torch.int64),
            "NumLabelChunks": fill(n_lab, torch.int64),
            "NumCorrectChunks": fill(n_correct, torch.int64)}


@register_op("ctc_align", no_grad_inputs=("Input",))
def ctc_align(ctx):
    """Merge repeated ids (``merge_repeated``) and drop ``blank`` in each
    sequence: int64 ``[M, 1]`` with its LoD (``[0, 1]`` when nothing is
    left)."""
    x = ctx.input("Input")
    off = ctx.seq_offsets("Input")
    blank = int(ctx.attr("blank", 0))
    merge = bool(ctx.attr("merge_repeated", True))
    (vals,) = _read_back(x)
    rows, offsets = [], [0]
    for i in range(len(off) - 1):
        prev = None
        for t in vals[off[i]:off[i + 1]]:
            if not (merge and t == prev) and t != blank:
                rows.append(t)
            prev = t
        offsets.append(len(rows))
    out = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 1),
                          device=x.device)
    return {"Output": out, "Output@LOD": [(tuple(offsets),)]}
