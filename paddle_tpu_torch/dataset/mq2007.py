"""LETOR MQ2007 learning-to-rank reader (counterpart of ``paddle_tpu/dataset/mq2007.py``;
upstream python/paddle/dataset/mq2007.py — train/test with format
"pointwise" (feature, score), "pairwise" (d_hi, d_lo), or "listwise"
(query's doc features + scores)).

Synthetic fallback: relevance is a fixed linear function of the 46
features plus noise, so rankers recover it."""

from __future__ import annotations

import numpy as np

N_FEATURES = 46
N_QUERIES = 120
DOCS_PER_QUERY = 8

_W = np.random.RandomState(99).normal(size=(N_FEATURES,)).astype(np.float32)


def _queries(seed):
    rng = np.random.RandomState(seed)
    for _ in range(N_QUERIES):
        feats = rng.normal(size=(DOCS_PER_QUERY, N_FEATURES)) \
            .astype(np.float32)
        raw = feats @ _W + rng.normal(0, 0.1, size=DOCS_PER_QUERY)
        # LETOR grades 0..2
        score = np.digitize(raw, np.quantile(raw, [0.5, 0.85]))
        yield feats, score.astype(np.float32)


def _reader(seed, format):
    def pointwise():
        for feats, score in _queries(seed):
            for f, s in zip(feats, score):
                yield f, float(s)

    def pairwise():
        for feats, score in _queries(seed):
            for i in range(len(score)):
                for j in range(len(score)):
                    if score[i] > score[j]:
                        yield feats[i], feats[j]

    def listwise():
        for feats, score in _queries(seed):
            yield feats, score

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return _reader(81, format)


def test(format="pairwise"):
    return _reader(82, format)
