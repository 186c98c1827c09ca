"""The ``moe_ffn`` op (counterpart of ``paddle_tpu/ops/moe_ops.py``),
single-device: routing by indices and the expert products as batched
products (``parallel/moe.py``).  Inside a process group of more than one
it raises, except in a data-parallel step, whose plan refuses it on a
batch-sharded input (its capacity counts the global batch's tokens).
The grad is the generic one, as in the reference: the gate values, the
expert weights and the input get gradients, the routing indices none.
"""

from __future__ import annotations

from ..parallel import moe, refuse_process_group
from .registry import register_op


@register_op("moe_ffn")
def moe_ffn_op(ctx):
    refuse_process_group("moe_ffn's expert parallelism")
    out, aux = moe.moe_ffn(
        ctx.input("X"),
        ctx.input("GateW"),
        ctx.input("W1"), ctx.input("B1"),
        ctx.input("W2"), ctx.input("B2"),
        top_k=int(ctx.attr("top_k", 2)),
        capacity_factor=float(ctx.attr("capacity_factor", 1.25)),
        activation=ctx.attr("activation", "relu"))
    res = {"Out": out}
    if ctx.n_outputs("AuxLoss"):
        res["AuxLoss"] = aux
    return res
