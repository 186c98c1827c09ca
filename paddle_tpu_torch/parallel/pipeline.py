"""A stack of equal-width fc layers (counterpart of
``paddle_tpu/parallel/pipeline.py``): the single-device half.

The reference runs the stack as a GPipe pipeline over a ``pp`` mesh axis
(``gpipe``: microbatches drained through the stages with one
``lax.ppermute`` hop a step) and, single-device, as
:func:`sequential_stack`, the same function.  Only the single-device half
is ported; the schedule over a process group comes with the multi-GPU
slice (``ROADMAP.md`` queue 1 item 12b), and the ``gpipe_mlp_stack`` op
refuses a group of more than one process meanwhile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_stage_fn(act: str):
    """Stage function for a stack of equal-width fc layers: params =
    (w [L/S, D, D], b [L/S, D])."""
    def fn(params, x):
        ws, bs = params
        for i in range(ws.shape[0]):
            x = _apply_act(x @ ws[i] + bs[i], act)
        return x
    return fn


def _apply_act(h, act: str):
    """The reference's activations; ``gelu`` is ``jax.nn.gelu``'s default,
    the tanh approximation."""
    if act == "relu":
        return torch.relu(h)
    if act == "tanh":
        return torch.tanh(h)
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act in (None, "", "none", "linear"):
        return h
    raise ValueError(f"unsupported pipeline activation {act!r}")


def sequential_stack(w, b, x, act: str):
    """Apply all L layers in order: ``x = act(x @ w[i] + b[i])``."""
    for i in range(w.shape[0]):
        x = _apply_act(x @ w[i] + b[i], act)
    return x
