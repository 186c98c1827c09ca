"""Weighted running average (counterpart of ``paddle_tpu/fluid/average.py``):
``WeightedAverage``, which train loops use to smooth per-batch metrics.
Host numpy, as the reference's."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight=1.0):
        # elementwise, like the reference: arrays stay arrays
        self.numerator = self.numerator + np.asarray(value,
                                                     dtype=np.float64) \
            * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "WeightedAverage: there is no data to be averaged")
        out = self.numerator / self.denominator
        return float(out) if np.ndim(out) == 0 else out
