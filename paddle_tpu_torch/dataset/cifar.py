"""CIFAR reader (counterpart of ``paddle_tpu/dataset/cifar.py``; upstream python/paddle/dataset/cifar.py); synthetic fallback."""

from __future__ import annotations

import numpy as np

TRAIN_SIZE = 4096
TEST_SIZE = 512


def _synthetic(n, classes, seed):
    rng = np.random.RandomState(seed)
    # class means from a FIXED seed so train/test share one distribution
    # (only labels/noise vary per split), like the real dataset
    means = np.random.RandomState(3217).uniform(
        0.2, 0.8, size=(classes, 3, 1, 1)).astype(np.float32)
    labels = rng.randint(0, classes, size=n).astype(np.int64)
    imgs = np.clip(means[labels] +
                   rng.normal(0, 0.2, size=(n, 3, 32, 32)).astype(np.float32),
                   0.0, 1.0)
    return imgs.reshape(n, 3 * 32 * 32), labels


def _reader(imgs, labels):
    def r():
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return r


def train10():
    return _reader(*_synthetic(TRAIN_SIZE, 10, 90151))


def test10():
    return _reader(*_synthetic(TEST_SIZE, 10, 90152))


def train100():
    return _reader(*_synthetic(TRAIN_SIZE, 100, 90153))


def test100():
    return _reader(*_synthetic(TEST_SIZE, 100, 90154))
