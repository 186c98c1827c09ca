"""The ``ring_attention`` op (counterpart of ``paddle_tpu/ops/attention_ops.py``).

Single-device it runs the flash kernels (:class:`~.flash_attention.
FlashAttention`: the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors) when flash is on and the bias is a key-padding bias, and
the plain full-softmax attention otherwise, as the reference does.  The
sequence-parallel ring over an ``sp`` mesh axis comes with the multi-GPU
slice: inside a ``torch.distributed`` group of more than one process the
op raises instead of guessing whether the sequence is sharded.

The op's grad is the generic one (``registry.run_grad_generic``): it
re-runs this forward under autograd, so each op launches the forward
kernel twice a step and the dQ and dK/dV kernels once each.
"""

from __future__ import annotations

import torch

from ..parallel import refuse_process_group
from ..parallel.ring_attention import full_attention
from .flash_attention import FlashAttention, bias_supported
from .registry import register_op


@register_op("ring_attention")
def ring_attention_op(ctx):
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")  # [B, H, T, D]
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    causal = bool(ctx.attr("causal", False))
    scale = ctx.attr("scale", 0.0) or None
    refuse_process_group(
        f"ring_attention over the {ctx.attr('sp_axis', 'sp')!r} axis (the "
        f"sequence-parallel ring)")
    if _flash_decision(int(ctx.attr("flash", -1)), q.device) \
            and bias_supported(bias, q.shape[0], k.shape[2]):
        out = FlashAttention.apply(q, k, v, bias, scale, causal)
    else:
        out = full_attention(q, k, v, causal, scale, bias=bias)
    return {"Out": out}


def _flash_decision(flash_req: int = -1, device=None) -> bool:
    """Whether attention takes the flash kernels: the per-op attr (1 on,
    0 off) wins; auto (-1) is on for CUDA tensors at run time (``device``)
    and, when a model is built (no device), on when torch sees a CUDA
    device.  The reference's ``PADDLE_TPU_FLASH`` env switch is not
    honoured: the port takes no env kill switch (ROADMAP.md)."""
    if flash_req != -1:
        return bool(flash_req)
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()
