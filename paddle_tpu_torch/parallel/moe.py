"""Mixture-of-experts feed-forward (counterpart of
``paddle_tpu/parallel/moe.py``): the single-device half.

The reference routes by dense ``[N, E, C]`` one-hot dispatch and combine
tensors and einsums over them, so the layer stays one static-shape XLA
program.  At a real size those tensors are the cost (8,192 tokens, 8
experts and a capacity of 2,560 make each one 671 MB in fp32), so the
port computes the same function by indices:

 - the gate in fp32: softmax, the top k experts of each token (ties to
   the lower expert index, as ``lax.top_k``), gate values renormalised
   over the chosen k with a floor of 1e-9;
 - each (token, choice)'s slot in its expert's buffer, in the reference's
   order: every token's first choice before any second choice, within a
   choice tokens in order, a slot at or past the capacity dropped; the
   slot positions are int64 counts, exact;
 - the kept tokens gathered into an ``[E, C, D]`` buffer (an empty slot
   holds zeros), the two expert products as batched ``torch.bmm`` in x's
   dtype (promoted with the weights' as ``jnp.einsum`` promotes,
   ``amp.promote``, not cast down by ``fluid.amp``), and each token's
   outputs gathered back, weighted by its gate values in x's dtype; a
   dropped choice adds 0.

An empty slot's output is weighted by zero in the reference too, the
routing indices carry no gradient, and the gate weights get theirs
through the gate values and the aux loss's mean probability, so the
values and gradients are the reference's.  Expert parallelism over an
``ep`` axis comes with the multi-GPU slice (``ROADMAP.md`` queue 1 item
12b).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .pipeline import _apply_act


def moe_capacity(n_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    return max(1, int(math.ceil(n_tokens * top_k / num_experts
                                * capacity_factor)))


class Routing(NamedTuple):
    """One routing of N tokens over E experts of capacity C.  ``slot``
    [N, k]: the flat slot ``e · C + position`` of each choice, ``E · C``
    for a dropped one; ``kept`` [E]: the tokens each expert took."""
    probs: torch.Tensor        # [N, E] fp32
    gate_idx: torch.Tensor     # [N, k] int64
    gate_vals: torch.Tensor    # [N, k] fp32, renormalised
    slot: torch.Tensor         # [N, k] int64
    kept: torch.Tensor         # [E] int64
    capacity: int
    aux_loss: torch.Tensor     # 0-d fp32


def top_k(probs, k: int):
    """``lax.top_k`` over the last dim: values in descending order, equal
    values by ascending index (``torch.topk`` does not promise an order
    for ties on CUDA); ``argmax`` returns the first maximum."""
    idx = []
    rest = probs
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    idx = torch.cat(idx, dim=-1)
    return probs.gather(-1, idx), idx


def route(x, gate_w, k: int, capacity_factor: float) -> Routing:
    """Route tokens ``x`` [N, D] through the gate ``gate_w`` [D, E]
    (the reference's ``top_k_gating`` as indices).  The aux loss is the
    Switch load-balancing loss ``E · sum_e(frac_first_choice_e ·
    mean_prob_e)``, 1 at perfect balance."""
    n = x.shape[0]
    e = gate_w.shape[-1]
    cap = moe_capacity(n, e, k, capacity_factor)
    # gate math in fp32: tiny logit differences decide routing
    probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device)
    slots = []
    for j in range(k):
        oh = F.one_hot(gate_idx[:, j], e)                     # [N, E]
        # the position this token would take in each expert's buffer
        pos = counts + torch.cumsum(oh, dim=0) - oh
        pos = pos.gather(1, gate_idx[:, j:j + 1])[:, 0]
        keep = pos < cap
        counts = counts + (oh * keep[:, None]).sum(0)
        slots.append(torch.where(keep, gate_idx[:, j] * cap + pos,
                                 e * cap))
    frac_routed = F.one_hot(gate_idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac_routed * probs.mean(0))
    return Routing(probs, gate_idx, gate_vals, torch.stack(slots, -1),
                   counts, cap, aux)


def dispatch_sources(slot, n_tokens: int, n_slots: int):
    """``[n_slots]``: the token that fills each slot, ``n_tokens`` (a zero
    row) for an empty one.  A slot takes at most one token; the dropped
    choices all point at the extra slot ``n_slots``, cut off."""
    src = torch.full((n_slots + 1,), n_tokens, dtype=torch.int64,
                     device=slot.device)
    tokens = torch.arange(n_tokens, device=slot.device)
    src.scatter_(0, slot.reshape(-1),
                 tokens[:, None].expand_as(slot).reshape(-1))
    return src[:n_slots]


def moe_ffn(x, gate_w, w1, b1, w2, b2, top_k: int = 2,
            capacity_factor: float = 1.25, activation: str = "relu"):
    """Expert feed-forward over routed tokens.  x: [..., D]; gate_w: [D, E];
    w1: [E, D, H]; b1: [E, H]; w2: [E, H, D]; b2: [E, D].  Returns
    (y [..., D], aux_loss 0-d in x's dtype)."""
    from ..fluid.amp import promote

    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e = gate_w.shape[-1]
    r = route(xt, gate_w, top_k, capacity_factor)
    cap = r.capacity
    src = dispatch_sources(r.slot, n, e * cap)
    expert_in = torch.cat([xt, xt.new_zeros(1, d)])[src].view(e, cap, d)
    h = _apply_act(torch.bmm(*promote(expert_in, w1)) + b1[:, None, :],
                   activation)
    expert_out = torch.bmm(*promote(h, w2)) + b2[:, None, :]
    out_rows = torch.cat([expert_out.reshape(e * cap, d),
                          expert_out.new_zeros(1, d)])
    gathered = out_rows[r.slot]                                  # [N, k, D]
    weights, gathered = promote(r.gate_vals.to(x.dtype)[:, :, None],
                                gathered)
    y = (weights * gathered).sum(1)
    return y.reshape(orig_shape), r.aux_loss.to(x.dtype)
