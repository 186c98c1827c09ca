"""WMT14 en-fr reader (counterpart of ``paddle_tpu/dataset/wmt14.py``; upstream python/paddle/dataset/wmt14.py — train/test
yield (src_ids, trg_ids, trg_ids_next); get_dict returns (src, trg) word
dicts; same <s>/<e>/<unk> = 0/1/2 convention as wmt16).

Synthetic fallback identical in shape/contract to the real set (zero-egress
environment); the deterministic permuted-reverse "translation" is learnable
by seq2seq models."""

from __future__ import annotations

from . import wmt16 as _w16

START_ID, END_ID, UNK_ID = _w16.START_ID, _w16.END_ID, _w16.UNK_ID


def train(dict_size):
    def reader():
        yield from _w16._synthetic_pairs(_w16.N_TRAIN, dict_size, dict_size,
                                         41)

    return reader


def test(dict_size):
    def reader():
        yield from _w16._synthetic_pairs(_w16.N_TEST, dict_size, dict_size,
                                         42)

    return reader


def get_dict(dict_size, reverse=False):
    """(src_dict, trg_dict) pair (ref wmt14.py get_dict)."""
    return (_w16.get_dict("en", dict_size, reverse),
            _w16.get_dict("fr", dict_size, reverse))
