"""Recurrent ops (counterpart of ``paddle_tpu/ops/rnn_ops.py``):
dynamic_lstm, dynamic_lstmp, dynamic_gru and the unit cells gru_unit and
lstm_unit.

The packed input is padded to ``[T, num_seq, ...]`` through index maps
built on the host from the offsets (the reference's ``_pad_indices``) and
cached on the device per (offsets, reverse, device); the reference's
``lax.scan`` over time is a loop over time here, each step a
``torch.matmul`` of the carried hidden state with the weight and the
elementwise gate math, with the validity mask carrying a finished
sequence's state on (``where(m_t, h, h_prev)``; skipped when every
sequence is ``T`` long, where it is the identity).  The scan is outside
any Pallas kernel in the reference, so this is plain PyTorch.  The grads
come from the generic grad (the reference's ``jax.vjp``).

Gate layouts follow the reference exactly:
 - lstm  Weight = {W_ch, W_ih, W_fh, W_oh}; Bias = {b_c, b_i, b_f, b_o}
   and, with use_peepholes, {W_ic, W_fc, W_oc} appended (``Bias[4D:7D]``).
 - gru   Weight = [W_u | W_r (D x 2D), W_c (D x D)];
   h_t = (1-u_t)*h_{t-1} + u_t*h~_t (``origin_mode``: u_t*h_{t-1} +
   (1-u_t)*h~_t).
 - lstm_unit X = [i, f, o, j]; C = C_prev*sig(f+forget_bias)+sig(i)*tanh(j).

``BatchGate`` / ``BatchCellPreAct`` / ``BatchHidden`` (and the GRU's
batch outputs) are zeros, as in the reference, made only when read.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from .sequence_ops import cached

_ACTS = {
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}
_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(name_or_enum, default):
    if name_or_enum is None:
        name_or_enum = default
    if isinstance(name_or_enum, int):
        name_or_enum = _ACT_ENUM[name_or_enum]
    return _ACTS[str(name_or_enum)]


def _pad_indices(off, reverse=False):
    """idx[t, i] = packed row of timestep t of sequence i (``total`` for
    padding), inv[row] = t * n + i, the mask [T, n], n and T."""
    off = np.asarray(off)
    lens = off[1:] - off[:-1]
    n = len(lens)
    total = int(off[-1])
    t_max = int(lens.max()) if n else 0
    idx = np.full((t_max, n), total, np.int64)
    inv = np.zeros((total,), np.int64)
    for i in range(n):
        rows = np.arange(off[i], off[i + 1])
        ts = np.arange(lens[i])
        if reverse:
            ts = lens[i] - 1 - ts
        idx[ts, i] = rows
        inv[rows] = ts * n + i
    mask = np.arange(t_max)[:, None] < lens[None, :]
    return idx, inv, mask, n, t_max


class _Padding:
    """The packed <-> time-major padded maps of one LoD on one device."""

    def __init__(self, off, reverse, device):
        idx, inv, mask, self.n, self.t_max = _pad_indices(off, reverse)
        self.full = bool(mask.all())
        self.idx = torch.as_tensor(idx, device=device)
        self.inv = torch.as_tensor(inv, device=device)
        self.mask = None if self.full else torch.as_tensor(
            mask[:, :, None], device=device)

    def pad(self, x):
        """``[total, ...]`` -> ``[T, n, ...]``, zero past each end."""
        xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return xp[self.idx]

    def pack(self, steps):
        """A list of T ``[n, ...]`` step outputs -> ``[total, ...]``."""
        flat = torch.stack(steps).reshape((-1,) + tuple(steps[0].shape[1:]))
        return flat.index_select(0, self.inv)

    def carry(self, t, new, prev):
        return new if self.full else torch.where(self.mask[t], new, prev)


def _padding(off, reverse, device) -> _Padding:
    """The :class:`_Padding` of ``(off, reverse, device)``, built on the
    host once and cached (``sequence_ops.cached``): a fixed-bucket step
    pays neither the host loop nor the host-to-device copies again."""
    key = ("rnn", tuple(int(v) for v in off), bool(reverse), str(device))
    return cached(key, lambda: _Padding(off, reverse, device))


@register_op("dynamic_lstm")
def dynamic_lstm(ctx):
    return _lstm_impl(ctx, project=False)


@register_op("dynamic_lstmp")
def dynamic_lstmp(ctx):
    return _lstm_impl(ctx, project=True)


def _lstm_impl(ctx, project):
    x = ctx.input("Input")          # [total, 4D] (projected by mul / fc)
    w = ctx.input("Weight")         # [D, 4D] (lstmp: [P, 4D])
    bias = ctx.input("Bias")        # [1, 4D] (+3D peephole tail)
    h0 = ctx.input("H0")
    c0 = ctx.input("C0")
    off = ctx.seq_offsets("Input")
    use_peep = bool(ctx.attr("use_peepholes", True))
    reverse = bool(ctx.attr("is_reverse", False))
    gate_act = _act(ctx.attr("gate_activation"), "sigmoid")
    cell_act = _act(ctx.attr("cell_activation"), "tanh")
    cand_act = _act(ctx.attr("candidate_activation"), "tanh")
    d = x.shape[1] // 4
    if project:
        proj_w = ctx.input("ProjWeight")   # [D, P]
        proj_act = _act(ctx.attr("proj_activation"), "identity")
        p = proj_w.shape[1]
    pad = _padding(off, reverse, x.device)
    xs = pad.pad(x)                                        # [T, n, 4D]
    if bias is not None:
        xs = xs + bias[:, :4 * d]
    w_ic = w_fc = w_oc = None
    if use_peep and bias is not None and bias.shape[-1] >= 7 * d:
        w_ic = bias[0, 4 * d:5 * d]
        w_fc = bias[0, 5 * d:6 * d]
        w_oc = bias[0, 6 * d:7 * d]

    h = h0 if h0 is not None else x.new_zeros((pad.n, p if project else d))
    c = c0 if c0 is not None else x.new_zeros((pad.n, d))
    hs, cs = [], []
    for t in range(pad.t_max):
        gates = xs[t] + torch.matmul(h, w)
        g_c, g_i, g_f, g_o = torch.split(gates, d, dim=1)
        if w_ic is not None:
            g_i = g_i + w_ic * c
            g_f = g_f + w_fc * c
        c_new = gate_act(g_f) * c + gate_act(g_i) * cand_act(g_c)
        if w_oc is not None:
            g_o = g_o + w_oc * c_new
        h_new = gate_act(g_o) * cell_act(c_new)
        if project:
            h_new = proj_act(torch.matmul(h_new, proj_w))
        h = pad.carry(t, h_new, h)
        c = pad.carry(t, c_new, c)
        hs.append(h)
        cs.append(c)
    hidden = pad.pack(hs) if hs else x.new_zeros((0, p if project else d))
    cell = pad.pack(cs) if cs else x.new_zeros((0, d))
    res = {"Projection" if project else "Hidden": hidden, "Cell": cell}
    if ctx.n_outputs("BatchGate"):
        res["BatchGate"] = torch.zeros_like(x)
    if ctx.n_outputs("BatchCellPreAct"):
        res["BatchCellPreAct"] = torch.zeros_like(cell)
    if ctx.n_outputs("BatchHidden"):
        res["BatchHidden"] = torch.zeros_like(hidden)
    return res


@register_op("dynamic_gru")
def dynamic_gru(ctx):
    x = ctx.input("Input")          # [total, 3D] = [xu | xr | xc]
    w = ctx.input("Weight")         # [D, 3D] = [W_u|W_r (D,2D), W_c (D,D)]
    bias = ctx.input("Bias")        # [1, 3D]
    h0 = ctx.input("H0")
    off = ctx.seq_offsets("Input")
    reverse = bool(ctx.attr("is_reverse", False))
    gate_act = _act(ctx.attr("gate_activation"), "sigmoid")
    cand_act = _act(ctx.attr("activation"), "tanh")
    origin_mode = bool(ctx.attr("origin_mode", False))
    d = x.shape[1] // 3
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    pad = _padding(off, reverse, x.device)
    xs = pad.pad(x)
    h = h0 if h0 is not None else x.new_zeros((pad.n, d))
    hs = []
    for t in range(pad.t_max):
        x_ur, x_c = xs[t][:, :2 * d], xs[t][:, 2 * d:]
        ur = x_ur + torch.matmul(h, w_ur)
        if bias is not None:
            ur = ur + bias[:, :2 * d]
        u, r = torch.split(gate_act(ur), d, dim=1)
        cand = x_c + torch.matmul(r * h, w_c)
        if bias is not None:
            cand = cand + bias[:, 2 * d:]
        cand = cand_act(cand)
        if origin_mode:
            h_new = u * h + (1.0 - u) * cand
        else:
            h_new = (1.0 - u) * h + u * cand
        h = pad.carry(t, h_new, h)
        hs.append(h)
    hidden = pad.pack(hs) if hs else x.new_zeros((0, d))
    res = {"Hidden": hidden}
    for slot in ("BatchGate", "BatchResetHiddenPrev", "BatchHidden"):
        if ctx.n_outputs(slot):
            width = 3 * d if slot == "BatchGate" else d
            res[slot] = x.new_zeros((x.shape[0], width))
    return res


@register_op("gru_unit")
def gru_unit(ctx):
    """One GRU step (activation attrs are int enums)."""
    x = ctx.input("Input")          # [B, 3D]
    h_prev = ctx.input("HiddenPrev")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    gate_act = _act(ctx.attr("gate_activation", 1), "sigmoid")
    cand_act = _act(ctx.attr("activation", 2), "tanh")
    d = h_prev.shape[1]
    xb = x + bias if bias is not None else x
    x_ur, x_c = xb[:, :2 * d], xb[:, 2 * d:]
    ur = gate_act(x_ur + torch.matmul(h_prev, w[:, :2 * d]))
    u, r = torch.split(ur, d, dim=1)
    reset_h = r * h_prev
    cand = cand_act(x_c + torch.matmul(reset_h, w[:, 2 * d:]))
    h = (1.0 - u) * h_prev + u * cand
    gate = torch.cat([u, r, cand], dim=1)
    return {"Gate": gate, "ResetHiddenPrev": reset_h, "Hidden": h}


@register_op("lstm_unit")
def lstm_unit(ctx):
    """X = [i, f, o, j], ``forget_bias`` added to f."""
    x = ctx.input("X")
    c_prev = ctx.input("C_prev")
    fb = float(ctx.attr("forget_bias", 0.0))
    i, f, o, j = torch.chunk(x, 4, dim=1)
    c = c_prev * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(j)
    h = c * torch.sigmoid(o)
    return {"C": c, "H": h}
