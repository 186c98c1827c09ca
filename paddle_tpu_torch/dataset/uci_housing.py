"""UCI housing reader (counterpart of ``paddle_tpu/dataset/uci_housing.py``; upstream python/paddle/dataset/uci_housing.py);
synthetic linear-regression fallback with the real 13-feature shape."""

from __future__ import annotations

import numpy as np

TRAIN_SIZE = 404
TEST_SIZE = 102

_rng = np.random.RandomState(90251)
_TRUE_W = _rng.uniform(-1, 1, size=13).astype(np.float32)


def _make(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, size=(n, 13)).astype(np.float32)
    y = (x @ _TRUE_W + 0.1 * rng.normal(0, 1, size=n)).astype(np.float32)
    return x, y.reshape(-1, 1)


def train():
    x, y = _make(TRAIN_SIZE, 90252)

    def reader():
        for i in range(len(x)):
            yield x[i], y[i]

    return reader


def test():
    x, y = _make(TEST_SIZE, 90253)

    def reader():
        for i in range(len(x)):
            yield x[i], y[i]

    return reader
