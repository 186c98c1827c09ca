"""Dataset → recordio conversion (counterpart of
``paddle_tpu/fluid/recordio_writer.py``; upstream's
``python/paddle/fluid/recordio_writer.py``).  The chunk format is the
native component (``paddle_tpu_torch/native/recordio.cc``); each sample
becomes one record packed by ``native.tensor_pack``, so the ``batch`` and
``shuffle`` reader decorators compose over it as upstream's do, and a file
written here reads in the JAX package and the other way round."""

from __future__ import annotations

import contextlib

import numpy as np

from ..native import RecordIOWriter
from ..native.tensor_pack import pack_batch
from .lod_tensor import LoDTensor

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files"]


@contextlib.contextmanager
def create_recordio_writer(filename, compressor=1, max_num_records=None,
                           max_chunk_bytes=1 << 20):
    w = RecordIOWriter(filename, compressor, max_chunk_bytes)
    try:
        yield w
    finally:
        w.close()


def _feed_to_items(fed: dict, feed_order):
    items = []
    for name in feed_order:
        v = fed[name]
        if isinstance(v, LoDTensor):
            items.append((np.asarray(v), v.lod()))
        else:
            items.append((np.asarray(v), ()))
    return items


def _records(reader_creator, feeder, feed_order):
    """One packed record a sample, the feeder's conversion applied."""
    for sample in reader_creator():
        yield pack_batch(_feed_to_items(feeder.feed([sample]), feed_order))


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor=1, max_num_records=1000,
                                    feed_order=None):
    """Write every sample of ``reader_creator`` as one record of
    ``filename``; returns the number of records."""
    feed_order = feed_order or feeder.feed_names
    counter = 0
    with create_recordio_writer(filename, compressor) as writer:
        for rec in _records(reader_creator, feeder, feed_order):
            writer.write(rec)
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder, compressor=1,
                                     max_num_records=1000, feed_order=None):
    """Write the samples into shards of ``batch_per_file`` records each,
    named ``<stem>-00000.<ext>``, ...; returns the shards' paths."""
    feed_order = feed_order or feeder.feed_names
    lines = []
    f_name, f_ext = filename.rsplit(".", 1) if "." in filename \
        else (filename, "recordio")
    batch = []

    def flush():
        if not batch:
            return
        path = f"{f_name}-{len(lines):05d}.{f_ext}"
        with create_recordio_writer(path, compressor) as w:
            for rec in batch:
                w.write(rec)
        lines.append(path)
        batch.clear()

    for rec in _records(reader_creator, feeder, feed_order):
        batch.append(rec)
        if len(batch) >= batch_per_file:
            flush()
    flush()
    return lines
