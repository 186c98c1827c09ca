"""Carrying persistable state into the port's scope, for any model
(``models.transformer`` and ``models.resnet`` both re-export it)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_reference_params(scope, arrays: Dict[str, np.ndarray], place):
    """Carry any persistable set across from the reference (or from another
    port scope): write every ``{name: ndarray}`` — parameters, optimizer
    accumulators (Adam moments and beta pows, momentum velocities), batch
    norm running means and variances, the learning-rate var, decode
    caches — into the port's scope tensor of the same name, in place, on
    ``place``'s device.  Raises KeyError for a name the scope does not hold
    and ValueError/TypeError on a shape or dtype mismatch — before writing
    anything."""
    from ..fluid import core

    device = core.torch_device(place)
    staged = []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        cur = scope.get(name)
        if cur is None:
            raise KeyError(f"the port's scope holds no var named {name!r} "
                           f"(run the model's startup program first)")
        if tuple(cur.shape) != tuple(arr.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} != "
                             f"port shape {tuple(cur.shape)}")
        if core.convert_dtype(cur.dtype) != core.convert_dtype(arr.dtype):
            raise TypeError(f"{name}: reference dtype {arr.dtype} != port "
                            f"dtype {cur.dtype}")
        if cur.device != device:
            raise ValueError(f"{name} lies on {cur.device}, not on "
                             f"{device}")
        staged.append((cur, arr))
    for cur, arr in staged:
        cur.copy_(torch.tensor(arr))
