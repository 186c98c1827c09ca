"""WMT16 en-de reader (counterpart of ``paddle_tpu/dataset/wmt16.py``; upstream python/paddle/dataset/wmt16.py — train/test
yield (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> at ids 0/1/2,
get_dict :318).

Synthetic fallback: a deterministic "translation" (target token = permuted
source token, reversed order) so seq2seq models can genuinely learn the
mapping — shapes and id conventions identical to the real set."""

from __future__ import annotations

import os

import numpy as np

from . import common

# same special-token convention as the reference loader
START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"
START_ID, END_ID, UNK_ID = 0, 1, 2

N_TRAIN = 2000
N_TEST = 200


def _synthetic_pairs(n, src_dict_size, trg_dict_size, seed):
    rng = np.random.RandomState(seed)
    v_src = max(src_dict_size - 3, 5)
    v_trg = max(trg_dict_size - 3, 5)
    # the "translation rule" (the permutation) comes from a FIXED seed so
    # train/test/validation teach and test the SAME mapping — only the
    # sampled sentences differ per split, as with a real corpus
    perm = np.random.RandomState(1604).permutation(max(v_src, v_trg))
    for _ in range(n):
        ln = int(rng.randint(3, 12))
        src = rng.randint(0, v_src, size=ln)
        trg = [int(perm[w] % v_trg) for w in reversed(src)]
        src_ids = [START_ID] + [int(w) + 3 for w in src] + [END_ID]
        trg_ids = [START_ID] + [int(w) + 3 for w in trg]
        trg_next = trg_ids[1:] + [END_ID]
        yield src_ids, trg_ids, trg_next


def get_dict(lang, dict_size, reverse=False):
    """id<->word table with the 3 specials first (ref :318)."""
    words = [START_MARK, END_MARK, UNK_MARK] + \
        [f"{lang}{i}" for i in range(dict_size - 3)]
    if reverse:
        return {i: w for i, w in enumerate(words)}
    return {w: i for i, w in enumerate(words)}


def train(src_dict_size, trg_dict_size, src_lang="en"):
    def reader():
        yield from _synthetic_pairs(N_TRAIN, src_dict_size, trg_dict_size, 31)

    return reader


def test(src_dict_size, trg_dict_size, src_lang="en"):
    def reader():
        yield from _synthetic_pairs(N_TEST, src_dict_size, trg_dict_size, 32)

    return reader


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    def reader():
        yield from _synthetic_pairs(N_TEST, src_dict_size, trg_dict_size, 33)

    return reader
