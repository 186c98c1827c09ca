"""MNIST reader (counterpart of ``paddle_tpu/dataset/mnist.py``; upstream python/paddle/dataset/mnist.py).

Real MNIST if cached locally; otherwise a deterministic synthetic set with
identical shapes ([784] float32 in [-1, 1], int64 label in [0, 10))."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def _synthetic(n, seed):
    # class means come from a FIXED seed shared by both splits — a model
    # trained on train() must generalize to test() exactly as with the
    # real dataset; only labels/noise vary per split
    means = np.random.RandomState(4117).uniform(
        -0.5, 0.5, size=(10, 784)).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    imgs = means[labels] + rng.normal(0, 0.3, size=(n, 784)).astype(np.float32)
    imgs = np.clip(imgs, -1.0, 1.0).astype(np.float32)
    return imgs, labels


def _reader_from_arrays(imgs, labels):
    def reader():
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def _load_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
        imgs = imgs.astype(np.float32) / 127.5 - 1.0
    with gzip.open(label_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
    return imgs, labels


def _maybe_real(split):
    d = common.cached_path("mnist")
    image = os.path.join(d, f"{split}-images-idx3-ubyte.gz")
    label = os.path.join(d, f"{split}-labels-idx1-ubyte.gz")
    if os.path.exists(image) and os.path.exists(label):
        return _load_idx(image, label)
    return None


def train():
    real = _maybe_real("train")
    if real is not None:
        return _reader_from_arrays(*real)
    return _reader_from_arrays(*_synthetic(TRAIN_SIZE, seed=90051))


def test():
    real = _maybe_real("t10k")
    if real is not None:
        return _reader_from_arrays(*real)
    return _reader_from_arrays(*_synthetic(TEST_SIZE, seed=90052))
