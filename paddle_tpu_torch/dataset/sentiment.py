"""NLTK movie-reviews sentiment reader (counterpart of ``paddle_tpu/dataset/sentiment.py``;
upstream python/paddle/dataset/sentiment.py — train/test yield (word-id list,
0/1 label); get_word_dict :64).

Synthetic fallback: two word distributions (positive ids low, negative ids
high, with overlap) — linearly separable, like the real set."""

from __future__ import annotations

import numpy as np

VOCAB = 400
N_TRAIN = 800
N_TEST = 200


def get_word_dict():
    return {f"w{i}": i for i in range(VOCAB)}


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(2))
        ln = int(rng.randint(8, 30))
        center = VOCAB // 4 if label else 3 * VOCAB // 4
        ids = np.clip(rng.normal(center, VOCAB // 6, size=ln), 0,
                      VOCAB - 1).astype(np.int64)
        yield list(ids), label


def train():
    def reader():
        yield from _samples(N_TRAIN, 61)

    return reader


def test():
    def reader():
        yield from _samples(N_TEST, 62)

    return reader
