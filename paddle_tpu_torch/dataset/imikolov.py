"""imikolov (PTB) n-gram / sequence reader (counterpart of ``paddle_tpu/dataset/imikolov.py``;
upstream python/paddle/dataset/imikolov.py — build_dict :64, train/test yield n-gram
id tuples :116 or seq pairs, DataType.NGRAM/SEQ).

Real PTB if cached under ~/.cache/paddle_tpu/dataset/imikolov/{train,valid}
.txt; otherwise a deterministic synthetic corpus with a learnable bigram
structure (each word strongly predicts its successor) so word2vec-style
models converge like they do on the real set."""

from __future__ import annotations

import os

import numpy as np

from . import common

VOCAB = 200
N_TRAIN_SENT = 2000
N_TEST_SENT = 200


class DataType:
    NGRAM = 1
    SEQ = 2


def _synthetic_corpus(n_sentences, seed):
    rng = np.random.RandomState(seed)
    # markov chain with a dominant successor per word -> learnable; the
    # successor table uses a FIXED seed so train/test share the language
    # model being learned (only the sampled sentences differ per split)
    succ = np.random.RandomState(2304).permutation(VOCAB)
    sents = []
    for _ in range(n_sentences):
        w = int(rng.randint(VOCAB))
        sent = [w]
        for _ in range(int(rng.randint(5, 15))):
            w = int(succ[w]) if rng.uniform() < 0.8 else int(rng.randint(VOCAB))
            sent.append(w)
        sents.append(["w%d" % w for w in sent])
    return sents


def _real_corpus(split):
    path = common.cached_path("imikolov", f"{split}.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [line.strip().split() for line in f if line.strip()]


def _corpus(split):
    real = _real_corpus(split)
    if real is not None:
        return real
    if split == "train":
        return _synthetic_corpus(N_TRAIN_SENT, 91)
    return _synthetic_corpus(N_TEST_SENT, 92)


def build_dict(min_word_freq=1):
    """word -> id; '<unk>' maps every OOV (ref :64 keeps '<s>'/'<e>' out)."""
    freq = {}
    for sent in _corpus("train"):
        for w in sent:
            freq[w] = freq.get(w, 0) + 1
    words = sorted([w for w, c in freq.items() if c >= min_word_freq],
                   key=lambda w: (-freq[w], w))
    word_idx = {w: i for i, w in enumerate(words)}
    word_idx["<unk>"] = len(words)
    return word_idx


def _reader(split, word_idx, n, data_type):
    unk = word_idx["<unk>"]

    def reader():
        for sent in _corpus(split):
            ids = [word_idx.get("<s>", unk)] + \
                [word_idx.get(w, unk) for w in sent] + \
                [word_idx.get("<e>", unk)]
            if data_type == DataType.NGRAM:
                if len(ids) >= n:
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n: i])
            else:
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader("train", word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader("test", word_idx, n, data_type)
