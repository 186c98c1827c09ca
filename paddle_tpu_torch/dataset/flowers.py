"""Oxford-102 flowers reader (counterpart of ``paddle_tpu/dataset/flowers.py``; upstream python/paddle/dataset/flowers.py —
train/test/valid yield (flattened 3x224x224 float image, int label)).

Synthetic fallback: class-conditioned color blobs, deterministic, so image
classifiers overfit the same way the real set allows."""

from __future__ import annotations

import numpy as np

N_CLASSES = 102
N_TRAIN = 512
N_TEST = 128
SHAPE = (3, 64, 64)  # reduced spatial size; same layout/contract


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-0.6, 0.6, size=(N_CLASSES, 3)).astype(np.float32)
    for _ in range(n):
        label = int(rng.randint(N_CLASSES))
        img = means[label][:, None, None] + \
            rng.normal(0, 0.25, size=SHAPE).astype(np.float32)
        yield np.clip(img, -1, 1).astype(np.float32).flatten(), label


def train(mapper=None, buffered_size=1024, use_xmap=False):
    def reader():
        yield from _rows(N_TRAIN, 21)

    return reader


def test(mapper=None, buffered_size=1024, use_xmap=False):
    def reader():
        yield from _rows(N_TEST, 22)

    return reader


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    def reader():
        yield from _rows(N_TEST, 23)

    return reader
