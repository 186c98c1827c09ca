"""Data-plane state blobs under the checkpoint ``_SUCCESS`` protocol
(counterpart of ``paddle_tpu/data/checkpoint.py``).

One small JSON blob per host rank (``data_state_<rank>.json``), written
into the STAGED serial directory before its ``_SUCCESS`` marker is
committed — so iterator position and model state are one atomic unit:
either both survive a kill or neither does, and the serial scroll-delete
prunes them together.  ``fluid.trainer.save_checkpoint(data_state=...)``
writes it and ``load_checkpoint`` reads it, treating an unreadable blob
like an unreadable param file: it FALLS BACK to the previous complete
serial (a corrupt cursor silently resuming at the wrong sample is the
exact failure this subsystem exists to kill).  The sharded multi-process
serials that also carry it come with multi-GPU (``ROADMAP.md`` queue 1
item 12).

``PADDLE_FAULT_SHARD_CORRUPT=1`` truncates the next write (one-shot):
the deterministic oracle for the fallback path.
"""

from __future__ import annotations

import json
import os
from typing import Optional

__all__ = ["DATA_STATE_PREFIX", "data_state_path", "save_data_state",
           "load_data_state", "load_all_data_states", "remap_data_state"]

DATA_STATE_PREFIX = "data_state_"
_VERSION = 1


def data_state_path(dirname: str, rank: int) -> str:
    return os.path.join(dirname, f"{DATA_STATE_PREFIX}{int(rank)}.json")


def save_data_state(dirname: str, state: dict, rank: int = 0) -> str:
    """Write one rank's iterator-state blob into a staged serial dir.

    tmp + rename so a concurrent reader never sees a torn write; the blob
    only becomes trusted when the CALLER commits the dir's ``_SUCCESS``
    marker.  Consults the shard-corrupt fault hook (truncated payload)
    so tests can deterministically exercise the load-side fallback."""
    from ..fluid import fault as _fault

    payload = json.dumps({"version": _VERSION, "rank": int(rank),
                          "state": state})
    if _fault.shard_corrupt():
        payload = payload[:max(1, len(payload) // 2)]
    path = data_state_path(dirname, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    _fault.io_delay()
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def load_data_state(dirname: str, rank: int = 0) -> Optional[dict]:
    """Read one rank's blob from a COMMITTED serial dir.

    Returns ``None`` when the serial simply has no data state (a
    checkpoint from before this subsystem, or a resume onto a rank the
    save never had) — the caller falls back to legacy sample-skip
    replay.  Raises ``IOError`` when a blob EXISTS but cannot be read
    (truncation, version drift): the caller must treat the whole serial
    as unreadable and fall back to the previous complete one, exactly
    like a corrupt param file."""
    path = data_state_path(dirname, rank)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        version = int(payload["version"])
        state = payload["state"]
    except (ValueError, KeyError, TypeError) as exc:
        raise IOError(
            f"data_state blob {path} is unreadable ({exc!r}) — treating "
            f"this serial as corrupt") from exc
    if version != _VERSION:
        raise IOError(
            f"data_state blob {path} has version {version}, this build "
            f"reads {_VERSION}")
    return state


def load_all_data_states(dirname: str) -> dict:
    """Every rank's blob from a COMMITTED serial dir: ``rank -> state``.

    The reshard-on-load path needs the WHOLE dead fleet's cursors (a
    dp4 serial resumed on dp2 merges two shard streams per new rank),
    not just this rank's.  Empty dict = legacy serial with no data
    plane; a blob that exists but cannot be read raises ``IOError``
    exactly like :func:`load_data_state` — the caller condemns the
    serial."""
    out = {}
    try:
        names = os.listdir(dirname)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(DATA_STATE_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            rank = int(name[len(DATA_STATE_PREFIX):-len(".json")])
        except ValueError:
            continue
        state = load_data_state(dirname, rank)
        if state is not None:
            out[rank] = state
    return out


def remap_data_state(dirname: str, old_layout: dict,
                     new_num_shards: int, new_shard_index: int):
    """This rank's resharded cursor from a serial committed under a
    DIFFERENT shard layout.

    ``old_layout`` maps each dead-fleet rank to its ``(num_shards,
    shard_index)`` pair (recorded in the serial's meta at save time, or
    re-derived via :func:`~paddle_tpu_torch.data.sharding.shard_layout`).
    tp/fsdp peers — ranks sharing one shard index — read identical data,
    so their blobs must agree byte-for-byte (the ``shard_spec``
    identical-data rule); they collapse to one cursor per stream before
    :func:`~paddle_tpu_torch.data.sharding.merge_cursor_states` re-keys the
    streams onto ``(new_num_shards, new_shard_index)``.

    Returns ``None`` when the serial carries no data states (legacy
    resume); raises ``ValueError`` by name on any inconsistency — a
    wrong guess here silently drops or double-consumes samples, which is
    the exact failure this subsystem exists to kill."""
    from .sharding import merge_cursor_states

    states = load_all_data_states(dirname)
    if not states:
        return None
    shard_counts = set()
    by_shard: dict = {}
    for rank, state in sorted(states.items()):
        pair = old_layout.get(rank, old_layout.get(str(rank)))
        if pair is None:
            raise ValueError(
                f"remap_data_state: serial has a cursor for rank {rank} "
                f"but the recorded shard layout covers only ranks "
                f"{sorted(old_layout)} — cannot tell which stream it "
                f"indexes")
        n, i = int(pair[0]), int(pair[1])
        shard_counts.add(n)
        prev = by_shard.get(i)
        if prev is None:
            by_shard[i] = state
        elif json.dumps(prev, sort_keys=True) != json.dumps(state,
                                                           sort_keys=True):
            raise ValueError(
                f"remap_data_state: ranks sharing shard stream {i} "
                f"committed DIFFERENT cursors — tp/fsdp peers must read "
                f"identical data; the serial is inconsistent")
    if len(shard_counts) != 1:
        raise ValueError(
            f"remap_data_state: recorded layout mixes shard counts "
            f"{sorted(shard_counts)}")
    old_n = shard_counts.pop()
    if sorted(by_shard) != list(range(old_n)):
        # the RECORDED stream count is authoritative: blobs covering only
        # a subset must not silently masquerade as a smaller fleet
        raise ValueError(
            f"remap_data_state: serial records {old_n} shard stream(s) "
            f"but cursors cover only {sorted(by_shard)} — a missing "
            f"stream would silently drop its unconsumed samples")
    return merge_cursor_states(by_shard, new_num_shards, new_shard_index)
