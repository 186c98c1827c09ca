"""Metric ops (counterpart of ``paddle_tpu/ops/metric_ops.py``): accuracy."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("accuracy", no_grad_inputs=("Out", "Indices", "Label"))
def accuracy(ctx):
    """Share of rows whose label is among the top-k ``Indices [N, k]``;
    ``Correct`` and ``Total`` are int32 ``[1]``, ``Accuracy`` float32
    ``[1]``."""
    indices, label = ctx.input("Indices"), ctx.input("Label")
    if label.dim() == 2:
        label = label.reshape(-1)
    hit = (indices == label[:, None].to(indices.dtype)).any(dim=1)
    correct = hit.sum(dtype=torch.int32)
    # a fill, not a copy from the host: a CUDA graph can capture it
    total = torch.full((), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    acc = correct.to(torch.float32) / total.to(torch.float32)
    return {"Accuracy": acc.reshape(1), "Correct": correct.reshape(1),
            "Total": total.reshape(1)}
