"""CoNLL-2005 SRL reader (counterpart of ``paddle_tpu/dataset/conll05.py``):
``test()`` yields 9-slot samples (word ids, the five context windows, the
predicate id, the mark, the IOB label ids); ``get_dict`` and
``get_embedding`` as upstream.

Synthetic: a deterministic predicate/argument structure (the words next
to the predicate are labelled as its arguments) so an SRL model can
learn."""

from __future__ import annotations

import numpy as np

WORD_VOCAB = 300
VERB_VOCAB = 30
# IOB labels over 2 chunk types + O: B-A0 I-A0 B-A1 I-A1 O
LABELS = ["B-A0", "I-A0", "B-A1", "I-A1", "O"]
N_TEST = 300


def get_dict():
    word_dict = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(VERB_VOCAB)}
    label_dict = {l: i for i, l in enumerate(LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """The PATH of the binary fp32 embedding file (a 16-byte header, then
    the rows; the book's SRL chapter reads it with ``np.fromfile``).
    Synthetic here, written to the cache once."""
    import os
    import tempfile

    from .common import cached_path, must_mkdirs

    path = cached_path("conll05", f"emb_{WORD_VOCAB}x32.bin")
    if not os.path.exists(path):
        must_mkdirs(os.path.dirname(path))
        rng = np.random.RandomState(5)
        arr = rng.normal(scale=0.1,
                         size=(WORD_VOCAB, 32)).astype(np.float32)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "wb") as f:
            f.write(b"\x00" * 16)  # the reference file's 16-byte header
            arr.tofile(f)
        os.replace(tmp, path)  # atomic publish; racers write their own tmp
    return path


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    o = LABELS.index("O")
    for _ in range(n):
        ln = int(rng.randint(5, 12))
        words = rng.randint(0, WORD_VOCAB, size=ln).astype(np.int64)
        vpos = int(rng.randint(ln))
        verb = int(words[vpos]) % VERB_VOCAB
        mark = np.zeros(ln, np.int64)
        mark[vpos] = 1
        labels = np.full(ln, o, np.int64)
        if vpos > 0:
            labels[vpos - 1] = LABELS.index("B-A0")
        if vpos + 1 < ln:
            labels[vpos + 1] = LABELS.index("B-A1")
        if vpos + 2 < ln:
            labels[vpos + 2] = LABELS.index("I-A1")

        def ctx(off):
            idx = np.clip(np.arange(ln) + off, 0, ln - 1)
            return words[idx]

        yield (list(words), list(ctx(-2)), list(ctx(-1)), list(ctx(0)),
               list(ctx(1)), list(ctx(2)),
               [verb] * ln, list(mark), list(labels))


def test():
    def reader():
        yield from _samples(N_TEST, 41)

    return reader
