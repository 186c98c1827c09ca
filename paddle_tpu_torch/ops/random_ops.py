"""Fill / assign / random ops (counterpart of
``paddle_tpu/ops/random_ops.py``): the startup and constant ops of the
decode programs.

RNG: the reference threads a JAX threefry key through the program; here a
``torch.Generator`` seeded from ``Program.random_seed`` lives on the op's
device for one Executor run, and an op with a nonzero ``seed`` attr uses its
own generator seeded from it.  The two draw different numbers from the same
seed, so tests compare by distribution or copy weights across.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_op


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


@register_op("uniform_random", stateful=True)
def uniform_random(ctx):
    device = ctx.device
    seed = ctx.attr("seed", 0)
    gen = ctx.generator
    if seed:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty(tuple(ctx.attr("shape")), dtype=_dtype(ctx),
                      device=device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=gen)}
