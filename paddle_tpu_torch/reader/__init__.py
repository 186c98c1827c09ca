"""Composable data readers (counterpart of ``paddle_tpu/reader``; upstream
python/paddle/reader/decorator.py) and ``batch``."""

from .decorator import (buffered, cache, chain, compose, firstn, map_readers,
                        shuffle, xmap_readers)

__all__ = ["buffered", "cache", "chain", "compose", "firstn", "map_readers",
           "shuffle", "xmap_readers", "batch"]


def batch(reader, batch_size, drop_last=False):
    """Group a sample reader into a minibatch reader (upstream
    python/paddle/batch.py)."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
