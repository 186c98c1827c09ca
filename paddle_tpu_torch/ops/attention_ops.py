"""The ``ring_attention`` op (counterpart of ``paddle_tpu/ops/attention_ops.py``).

The op runs :func:`~.flash_attention.flash_attention_sharded` on the
heads it is given: every head on one device, the rank's heads in a
tensor-parallel step (``parallel/placement.py``).  That runs the flash
kernels (:class:`~.flash_attention.FlashAttention`: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors) when flash is on and
the bias is a key-padding bias, and the plain full-softmax attention
otherwise, as the reference does.  The sequence-parallel ring over an
``sp`` mesh axis comes with ROADMAP.md queue 1 item 12b step 4: inside a
group of more than one process, outside a dp / tp / fsdp step, the op
raises instead of guessing whether the sequence is sharded.

The op's grad is the generic one (``registry.run_grad_generic``): it
re-runs this forward under autograd, so each op launches the forward
kernel twice a step and the dQ and dK/dV kernels once each.
"""

from __future__ import annotations

import torch

from ..parallel import refuse_process_group
from .flash_attention import flash_attention_sharded
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
    return {"Out": flash_attention_sharded(
        q, k, v, bias, scale, causal,
        _flash_decision(int(ctx.attr("flash", -1)), q.device))}


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
