"""IMDB sentiment reader (counterpart of ``paddle_tpu/dataset/imdb.py``; upstream python/paddle/dataset/imdb.py);
synthetic fallback: integer token sequences with class-correlated tokens."""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 5147
TRAIN_SIZE = 2048
TEST_SIZE = 256


def word_dict():
    return {i: i for i in range(VOCAB_SIZE)}


def _make(n, seed):
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 120))
        base = rng.randint(0, VOCAB_SIZE // 2, size=length)
        if label:
            base = base + VOCAB_SIZE // 2  # positive-class tokens
        samples.append((base.astype(np.int64).tolist(), label))
    return samples


def train(word_idx=None):
    data = _make(TRAIN_SIZE, 90351)

    def reader():
        for seq, label in data:
            yield seq, label

    return reader


def test(word_idx=None):
    data = _make(TEST_SIZE, 90352)

    def reader():
        for seq, label in data:
            yield seq, label

    return reader
