"""Fill / assign / random ops (counterpart of
``paddle_tpu/ops/random_ops.py``): the startup ops, constants, the
backward seed (``fill_any_like``) and dropout.

RNG: the reference threads a JAX threefry key through the program; here
the Executor hands random ops the scope's ``torch.Generator`` for the
op's device (``fluid/executor.py``), and an op with a nonzero ``seed``
attr uses its own generator seeded from it.  The two draw different
numbers from the same seed, so tests compare by distribution or copy
weights across.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_grad, register_op


def _dtype(ctx):
    from ..fluid import core as _core

    return _core.torch_dtype(ctx.attr("dtype", "float32"))


@register_op("fill_constant")
def fill_constant(ctx):
    return {"Out": torch.full(tuple(ctx.attr("shape", [])),
                              ctx.attr("value", 0.0), dtype=_dtype(ctx),
                              device=ctx.device)}


@register_op("assign_value")
def assign_value(ctx):
    from ..fluid import core as _core

    vals = ctx.attr("fp32_values") or ctx.attr("int32_values") \
        or ctx.attr("values")
    arr = np.array(vals, _core.np_dtype(ctx.attr("dtype", "float32")))
    return {"Out": torch.from_numpy(arr.reshape(ctx.attr("shape"))).to(
        ctx.device)}


def _generator(ctx, device):
    seed = ctx.attr("seed", 0)
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return ctx.generator


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx):
    x = ctx.input("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[
        ctx.attr("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), ctx.attr("value", 0.0),
                              dtype=_dtype(ctx), device=x.device)}


@register_op("fill_any_like")
def fill_any_like(ctx):
    """Also the backward seed ``append_backward`` tags ``__loss_seed__``:
    run as a plain op (the loss-scale multiplier comes with AMP)."""
    return {"Out": torch.full_like(ctx.input("X"), ctx.attr("value", 0.0))}


@register_op("uniform_random", stateful=True)
def uniform_random(ctx):
    device = ctx.device
    out = torch.empty(tuple(ctx.attr("shape")), dtype=_dtype(ctx),
                      device=device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=_generator(ctx, device))}


@register_op("gaussian_random", stateful=True)
def gaussian_random(ctx):
    device = ctx.device
    z = torch.randn(tuple(ctx.attr("shape")), dtype=_dtype(ctx),
                    device=device, generator=_generator(ctx, device))
    return {"Out": ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z}


@register_op("dropout", stateful=True)
def dropout(ctx):
    """Keep each element with probability ``1 - dropout_prob``; ``Mask``
    is the keep mask (scaled by ``1 / (1 - p)`` for
    ``upscale_in_train``), saved for ``dropout_grad``."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    upscale = ctx.attr("dropout_implementation",
                       "downgrade_in_infer") == "upscale_in_train"
    if ctx.attr("is_test", False):
        return {"Out": x if upscale else x * (1.0 - p),
                "Mask": torch.ones_like(x)}
    u = torch.rand(x.shape, device=x.device,
                   generator=_generator(ctx, x.device))
    mask = (u < 1.0 - p).to(x.dtype)
    if upscale:
        mask = mask / max(1.0 - p, 1e-12)
    return {"Out": x * mask, "Mask": mask}


@register_grad("dropout")
def dropout_grad(ctx):
    """Reuses the saved mask: a fresh draw would decorrelate forward and
    backward (ref: ``paddle_tpu/ops/random_ops.py:dropout_grad``)."""
    return {"X@GRAD": ctx.input("Out@GRAD") * ctx.input("Mask")}
