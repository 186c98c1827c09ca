"""Quantization ops (counterpart of ``paddle_tpu/ops/quant_ops.py``): the
weight-only int8 ``dequantize_weight`` that the int8 weight transpiler
(``fluid/transpiler/int8_transpiler.py``) puts before each consumer of a
quantized weight, and the quantization-aware-training ops
``fake_quantize_abs_max``, ``fake_quantize_range_abs_max`` and
``fake_dequantize_max_abs`` with straight-through grads (the incoming
grad passes the rounding unchanged).

``torch.round`` rounds half to even, as ``jnp.round`` does, so a tie
lands on the reference's integer.  A division by a constant (127,
``max_range``) is a product with its float32 reciprocal, as the
reference's compiled program computes it (XLA rewrites the division), so
the outputs are the reference's bit for bit.

``dequantize_weight`` writes a float32 copy of its weight every run: the
reference's XLA fuses the cast and scale into the consuming matmul or
convolution, eager PyTorch does not.  The int8 tensor stays the only copy
the scope holds.
"""

from __future__ import annotations

import torch

from .registry import register_grad, register_op


def _bin_cnt(bits):
    return float(2 ** (bits - 1) - 1)


def _quantize(x, scale, bits):
    """``round(x / scale · (2^(bits-1) − 1))``, a zero scale read as 1."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(x / safe * _bin_cnt(bits))


@register_op("dequantize_weight", no_grad_inputs=("X", "Scale"))
def dequantize_weight(ctx):
    """``X`` (int8) × ``Scale`` / 127 along ``quant_axis``, in float32."""
    x, scale = ctx.input("X"), ctx.input("Scale")
    shape = [1] * x.dim()
    shape[int(ctx.attr("quant_axis", 0))] = -1
    return {"Out": x.to(torch.float32)
            * (scale.reshape(shape) * (1.0 / 127.0))}


@register_op("fake_quantize_abs_max", no_grad_inputs=())
def fake_quantize_abs_max(ctx):
    """``X`` rounded to ``bit_length`` bits at the scale of its largest
    magnitude (``OutScale [1]``)."""
    x = ctx.input("X")
    scale = x.abs().amax()
    return {"Out": _quantize(x, scale, ctx.attr("bit_length", 8)),
            "OutScale": scale.reshape(1)}


@register_grad("fake_quantize_abs_max")
def fake_quantize_abs_max_grad(ctx):
    return {"X@GRAD": ctx.input("Out@GRAD")}


@register_op("fake_quantize_range_abs_max",
             no_grad_inputs=("InScale", "Iter"))
def fake_quantize_range_abs_max(ctx):
    """Training: the batch's largest magnitude goes into ``OutScales[Iter
    % window_size]`` (a window the op creates at zeros when the output
    holds none) and the scale is the window's largest; ``IterOut`` is
    ``Iter + 1``.  ``is_test``: the scale is ``InScale`` and the state
    passes through."""
    x = ctx.input("X")
    in_scale = ctx.input("InScale").reshape(())
    it = ctx.input("Iter")
    scales = ctx.cur_out("OutScales")
    window = int(ctx.attr("window_size", 10000))
    cur = x.abs().amax()
    if ctx.attr("is_test", False):
        scale, new_scales, new_iter = in_scale, scales, it
    else:
        if scales is None:
            scales = torch.zeros((window,), dtype=x.dtype, device=x.device)
        idx = torch.remainder(it.reshape(1).to(torch.int64), window)
        new_scales = scales.index_put((idx,), cur.reshape(1))
        scale = torch.maximum(new_scales.amax(), cur)
        new_iter = it + 1
    return {"Out": _quantize(x, scale, ctx.attr("bit_length", 8)),
            "OutScale": scale.reshape(1), "OutScales": new_scales,
            "IterOut": new_iter}


@register_grad("fake_quantize_range_abs_max")
def fake_quantize_range_abs_max_grad(ctx):
    return {"X@GRAD": ctx.input("Out@GRAD")}


@register_op("fake_dequantize_max_abs", no_grad_inputs=("Scale",))
def fake_dequantize_max_abs(ctx):
    """``X · Scale / max_range``."""
    scale = ctx.input("Scale").reshape(())
    return {"Out": ctx.input("X")
            * (scale * (1.0 / ctx.attr("max_range", 1.0)))}


@register_grad("fake_dequantize_max_abs")
def fake_dequantize_max_abs_grad(ctx):
    scale = ctx.input("Scale").reshape(())
    return {"X@GRAD": ctx.input("Out@GRAD")
            * (scale * (1.0 / ctx.attr("max_range", 1.0)))}
