"""PASCAL VOC2012 segmentation reader (counterpart of ``paddle_tpu/dataset/voc2012.py``;
upstream python/paddle/dataset/voc2012.py — train/test/val yield (image CHW float,
label mask HW int32)).

Synthetic fallback: images containing a colored rectangle whose mask is the
label — segmentation models can fit it."""

from __future__ import annotations

import numpy as np

N_CLASSES = 21
SHAPE = (3, 48, 48)
N_TRAIN = 200
N_TEST = 50


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        img = rng.normal(0, 0.1, size=SHAPE).astype(np.float32)
        mask = np.zeros(SHAPE[1:], np.int32)
        cls = int(rng.randint(1, N_CLASSES))
        y0, x0 = rng.randint(4, 20, size=2)
        h, w = rng.randint(8, 24, size=2)
        mask[y0:y0 + h, x0:x0 + w] = cls
        img[:, y0:y0 + h, x0:x0 + w] += cls / N_CLASSES
        yield img, mask


def train():
    def reader():
        yield from _samples(N_TRAIN, 71)

    return reader


def test():
    def reader():
        yield from _samples(N_TEST, 72)

    return reader


def val():
    def reader():
        yield from _samples(N_TEST, 73)

    return reader
