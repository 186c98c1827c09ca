"""The stacked transformer encoder / decoder ops (counterpart of
``paddle_tpu/ops/transformer_ops.py``), single-device: a loop over the
stacked layers (``parallel/transformer_stack.py``).  Inside a process
group of more than one they raise: the pp / mp / sp layouts come with the
multi-GPU slice.

Gradients: the forward draws residual dropout masks, so the generic grad
(a re-run of the forward) would draw others.  The forward therefore emits
what it drew under ``RngKey`` (the reference emits the PRNG key it used;
the port its keep masks, ``[L, sites, N, T, D]`` bool, or the reference's
zero key when nothing was drawn), and the explicit grad re-runs the stack
under autograd over those masks: the same masks, exact gradients.  The
re-run launches each attention's flash forward a second time, as the
generic grad does.
"""

from __future__ import annotations

import torch

from ..parallel import refuse_process_group
from ..parallel import transformer_stack as ts
from .attention_ops import _flash_decision
from .registry import GRAD_SUFFIX, register_grad, register_op


def _stack_args(ctx, decoder):
    x = ctx.input("X")
    slots = ts.DECODER_SLOTS if decoder else ts.ENCODER_SLOTS
    return dict(
        kind="dec" if decoder else "enc",
        enc=ctx.input("EncOut") if decoder else None,
        bias=ctx.input("Bias") if ctx.has_input("Bias") else None,
        params={s: ctx.input(s) for s in slots},
        n_head=int(ctx.attr("n_head")),
        dropout=float(ctx.attr("dropout", 0.0)),
        is_test=bool(ctx.attr("is_test", False)),
        recompute=bool(ctx.attr("recompute", False)),
        flash=_flash_decision(int(ctx.attr("flash", -1)), x.device))


def _draws(a) -> bool:
    return bool(a["dropout"]) and not a["is_test"]


def _forward(ctx, decoder):
    refuse_process_group(f"{ctx.op_type}'s pp / mp / sp layouts")
    a = _stack_args(ctx, decoder)
    x = ctx.input("X")
    if _draws(a):
        key = masks = ts.draw_masks(
            ctx.generator, a["params"]["WQ"].shape[0],
            ts.DECODER_SITES if decoder else ts.ENCODER_SITES, x.shape,
            a["dropout"], x.device)
    else:
        masks = None
        key = torch.zeros(2, dtype=torch.int32, device=x.device)
    out = ts.stack_apply(a["kind"], x, a["enc"], a["bias"], a["params"],
                         masks, n_head=a["n_head"], dropout=a["dropout"],
                         is_test=a["is_test"], recompute=a["recompute"],
                         flash=a["flash"])
    return {"Out": out, "RngKey": key}


def _backward(ctx, decoder):
    from ..fluid import amp

    a = _stack_args(ctx, decoder)
    masks = ctx.input("RngKey") if _draws(a) else None
    # the bias, derived from the input's padding, takes no grad
    want = [slot[:-len(GRAD_SUFFIX)] for slot in ctx.outputs_spec
            if slot != "Bias" + GRAD_SUFFIX]
    inputs = {"X": ctx.input("X"), "EncOut": a["enc"], **a["params"]}
    leaves = {s: inputs[s].detach().requires_grad_() for s in want}
    args = {s: leaves.get(s, v) for s, v in inputs.items()}
    gout = ctx.input("Out@GRAD")
    with amp.fp32_sums():
        with torch.enable_grad():
            out = ts.stack_apply(
                a["kind"], args["X"], args["EncOut"], a["bias"],
                {s: args[s] for s in a["params"]}, masks,
                n_head=a["n_head"], dropout=a["dropout"],
                is_test=a["is_test"], recompute=a["recompute"],
                flash=a["flash"])
        grads = torch.autograd.grad(
            out, list(leaves.values()),
            torch.zeros_like(out) if gout is None else gout.to(out.dtype),
            allow_unused=True)
    return {s + GRAD_SUFFIX: torch.zeros_like(t) if g is None else g
            for (s, t), g in zip(leaves.items(), grads)}


@register_op("transformer_encoder_stack", stateful=True,
             no_grad_inputs=("Bias",))
def transformer_encoder_stack_op(ctx):
    return _forward(ctx, decoder=False)


@register_grad("transformer_encoder_stack")
def transformer_encoder_stack_grad(ctx):
    return _backward(ctx, decoder=False)


@register_op("transformer_decoder_stack", stateful=True,
             no_grad_inputs=("Bias",))
def transformer_decoder_stack_op(ctx):
    return _forward(ctx, decoder=True)


@register_grad("transformer_decoder_stack")
def transformer_decoder_stack_grad(ctx):
    return _backward(ctx, decoder=True)
