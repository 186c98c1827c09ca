"""Data layer (counterpart of ``paddle_tpu/fluid/layers/io.py:data``)."""

from __future__ import annotations

from .. import core
from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(
        name=name, shape=shape, dtype=core.convert_dtype(dtype),
        lod_level=lod_level, stop_gradient=stop_gradient, is_data=True)
