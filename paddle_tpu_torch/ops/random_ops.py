"""Fill / assign / random ops (counterpart of
``paddle_tpu/ops/random_ops.py``): the startup ops, constants (host
values where every reader takes one), ``assign``, the backward seed
(``fill_any_like``), ``fill_zeros_like``, the draws (uniform, normal,
their batch-size-like forms, truncated normal, ``sampling_id``), dropout,
``shuffle_channel`` and ``range``.

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
    """On the device, or a host (numpy) value when every reader of the
    output takes one (``ctx.host``: a loop counter, a bound, a condition),
    as the reference's ``fill_constant`` always makes one."""
    if ctx.host:
        from ..fluid import core as _core

        return {"Out": np.full(tuple(ctx.attr("shape", [])),
                               ctx.attr("value", 0.0),
                               _core.np_dtype(ctx.attr("dtype", "float32")))}
    return {"Out": torch.full(tuple(ctx.attr("shape", [])),
                              ctx.attr("value", 0.0), dtype=_dtype(ctx),
                              device=ctx.device)}


@register_op("assign")
def assign(ctx):
    """A copy of X (never X itself: the output may be a persistable that
    an optimizer later updates in place)."""
    return {"Out": ctx.input("X").clone()}


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


@register_op("fill_zeros_like")
def fill_zeros_like(ctx):
    return {"Out": torch.zeros_like(ctx.input("X"))}


@register_op("fill_any_like")
def fill_any_like(ctx):
    """Also the backward seed ``append_backward`` tags ``__loss_seed__``;
    a guarded Executor step multiplies its output by the loss scale."""
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


def _batch_size_like_shape(ctx, x):
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[
        ctx.attr("input_dim_idx", 0)]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", stateful=True)
def uniform_random_batch_size_like(ctx):
    """``uniform_random`` of ``shape`` with ``shape[output_dim_idx] =
    Input.shape[input_dim_idx]``."""
    x = ctx.input("Input")
    out = torch.empty(_batch_size_like_shape(ctx, x), dtype=_dtype(ctx),
                      device=x.device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=_generator(ctx, x.device))}


@register_op("gaussian_random_batch_size_like", stateful=True)
def gaussian_random_batch_size_like(ctx):
    x = ctx.input("Input")
    z = torch.randn(_batch_size_like_shape(ctx, x), dtype=_dtype(ctx),
                    device=x.device, generator=_generator(ctx, x.device))
    return {"Out": ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z}


@register_op("truncated_gaussian_random", stateful=True)
def truncated_gaussian_random(ctx):
    """``mean + std · z`` with ``z`` standard normal truncated to [−2, 2]
    (the bounds of ``trunc_normal_`` are absolute, so they are given in
    the standard variable, before the scaling)."""
    device = ctx.device
    z = torch.empty(tuple(ctx.attr("shape")), dtype=_dtype(ctx),
                    device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                generator=_generator(ctx, device))
    return {"Out": ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z}


@register_op("sampling_id", stateful=True, no_grad_inputs=("X",))
def sampling_id(ctx):
    """One int64 draw a row of ``X`` with odds proportional to the row
    (the reference's ``categorical(log(max(x, 1e-20)))``; rows need not
    sum to 1), by Gumbel-max: the argmax of ``log p − log(−log U)``, on
    the device with no host sync."""
    x = ctx.input("X")
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                   generator=_generator(ctx, x.device))
    logits = torch.log(torch.clamp(x.float(), min=1e-20))
    return {"Out": torch.argmax(logits - torch.log(-torch.log(u)), -1)}


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
        from ..fluid import amp

        mask = mask / amp.weak_scalar(max(1.0 - p, 1e-12), x.dtype)
    return {"Out": x * mask, "Mask": mask}


@register_grad("dropout")
def dropout_grad(ctx):
    """Reuses the saved mask: a fresh draw would decorrelate forward and
    backward (ref: ``paddle_tpu/ops/random_ops.py:dropout_grad``)."""
    return {"X@GRAD": ctx.input("Out@GRAD") * ctx.input("Mask")}


@register_op("shuffle_channel")
def shuffle_channel(ctx):
    """Channels ``g·(c/g)`` read as ``[g, c/g]`` and written transposed."""
    x = ctx.input("X")
    g = ctx.attr("group", 1)
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
        n, c, h, w)}


@register_op("range", no_grad_inputs=("Start", "End", "Step"))
def range_op(ctx):
    """``Start + Step · arange(_static_len)`` in Start's dtype; like the
    reference, the length must be the static attr (a length read from the
    device values is not supported)."""
    n = ctx.attr("_static_len", None)
    if n is None:
        raise NotImplementedError("range op requires its static length "
                                  "(the _static_len attr)")
    s = ctx.input("Start").reshape(())
    st = ctx.input("Step").reshape(())
    return {"Out": s + st * torch.arange(n, dtype=s.dtype, device=s.device)}
