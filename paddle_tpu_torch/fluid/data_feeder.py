"""DataFeeder: minibatch list -> feed dict (counterpart of
``paddle_tpu/fluid/data_feeder.py``): numpy arrays, and a ``LoDTensor``
for a var with a LoD level.  ``feed_parallel`` comes with multi-GPU."""

from __future__ import annotations

import numpy as np

from . import core
from .framework import Variable, default_main_program
from .lod_tensor import LoDTensor

__all__ = ["DataFeeder"]


class DataToLoDTensorConverter:
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = [d for d in shape]
        self.dtype = core.np_dtype(dtype)
        self.data = []
        self.lod = [[0] for _ in range(lod_level)]

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(lod[0][-1] + len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            shape = [-1 if d in (-1, None) else d for d in self.shape]
            try:
                arr = arr.reshape(shape)
            except ValueError:
                pass
            return arr
        flat = np.array(self.data, dtype=self.dtype)
        if flat.ndim == 1:
            flat = flat.reshape(
                [-1] + [d for d in self.shape if d not in (-1, None)])
        return LoDTensor(flat, self.lod)


class DataFeeder:
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block()._var_recursive(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variables or names")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        converters = [
            DataToLoDTensorConverter(self.place, lod_level, shape, dtype)
            for lod_level, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes)
        ]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), \
                "sample width != number of feed variables"
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}
