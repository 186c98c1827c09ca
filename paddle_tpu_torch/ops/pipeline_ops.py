"""The ``gpipe_mlp_stack`` op (counterpart of
``paddle_tpu/ops/pipeline_ops.py``), single-device: the layers apply in
order (``parallel/pipeline.py`` ``sequential_stack``), the reference's
fallback without a ``pp`` mesh axis and the same function as its GPipe
schedule.  Inside a process group of more than one it raises.  The grad
is the generic one, as in the reference.
"""

from __future__ import annotations

from ..parallel import refuse_process_group
from ..parallel.pipeline import sequential_stack
from .registry import register_op


@register_op("gpipe_mlp_stack")
def gpipe_mlp_stack_op(ctx):
    refuse_process_group(
        f"gpipe_mlp_stack's GPipe schedule over the "
        f"{ctx.attr('pp_axis', 'pp')!r} axis")
    x = ctx.input("X")            # [N, D]
    w = ctx.input("W")            # [L, D, D]
    b = ctx.input("B")            # [L, D]
    return {"Out": sequential_stack(w, b, x, ctx.attr("act", "relu"))}
