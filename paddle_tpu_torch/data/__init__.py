"""paddle_tpu_torch.data — the checkpointable streaming data plane
(counterpart of ``paddle_tpu/data``).

An input pipeline whose ITERATOR POSITION is a checkpoint artifact: state
blobs commit atomically with model state under the serial-dir
``_SUCCESS`` protocol (one per host rank), and a resumed run consumes the
byte-identical sample sequence an uninterrupted run would have, starting
at the first un-committed sample.

    from paddle_tpu_torch import data

    pipe = (data.from_reader(sample_reader)
                .shuffle(512, seed=7)     # resumable, keyed on (seed, epoch)
                .batch(64))
    trainer.train(..., reader=pipe)       # Trainer commits/restores state

Pieces: :mod:`pipeline` (the CheckpointableIterator protocol and the
stages), :mod:`sharding` (a mesh spec → per-host shard assignment, cursor
remaps), :mod:`prefetch` (window staging whose uncommitted lookahead is
replayed, never lost), :mod:`checkpoint` (the per-rank ``data_state`` blob
under ``_SUCCESS``).
"""

from .checkpoint import (DATA_STATE_PREFIX, data_state_path,
                         load_all_data_states, load_data_state,
                         remap_data_state, save_data_state)
from .pipeline import (COUNTERS, CheckpointableIterator, Pipeline,
                       from_reader, is_checkpointable, note_data_wait,
                       reset_counters, timed)
from .prefetch import CheckpointablePrefetcher
from .sharding import (data_axis_extent, merge_cursor_states, shard_layout,
                       shard_spec)

__all__ = [
    "CheckpointableIterator", "Pipeline", "from_reader",
    "is_checkpointable", "note_data_wait", "timed", "COUNTERS",
    "reset_counters", "CheckpointablePrefetcher", "shard_spec",
    "data_axis_extent", "shard_layout", "merge_cursor_states",
    "DATA_STATE_PREFIX", "data_state_path", "save_data_state",
    "load_data_state", "load_all_data_states", "remap_data_state",
]
