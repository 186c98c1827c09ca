"""Per-host data-shard assignment derived from the named mesh (counterpart
of ``paddle_tpu/data/sharding.py``).

A mesh spec (``PADDLE_TPU_MESH=dp4,tp2``, or the string itself) fixes how
the GLOBAL batch is laid out over devices: the ``dp`` axis consumes
distinct samples, every other axis (tp/fsdp/pp/…) replicates them.  The
data plane must agree with that layout per HOST: two hosts whose devices
sit in the same dp group must read the SAME samples (their tp shards see
one batch), hosts in different dp groups must read DISJOINT samples, and
the union over all hosts must cover the dataset exactly once per dp
group.  :func:`shard_spec` reduces that to the round-robin
``(num_shards, shard_index)`` pair ``Pipeline.shard`` consumes; hosts are
assumed laid out process-major along the dp axis.  These computations need
no mesh object: a spec string, an ``[[name, extent], ...]`` list or an
``{axis: extent}`` dict describes the topology.  A device mesh object
comes with multi-GPU (``ROADMAP.md`` queue 1 item 12).
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Optional, Tuple

__all__ = ["shard_spec", "data_axis_extent", "shard_layout",
           "merge_cursor_states", "parse_mesh_spec", "axes_of"]

#: mesh axes that consume distinct samples (every other axis replicates
#: the batch — tp shards activations, fsdp shards weights, pp stages see
#: the same microbatch stream)
DATA_AXES = ("dp",)

_AXIS_RE = re.compile(r"([a-zA-Z_]+?)(\d+)$")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp4,tp2"`` -> ``{"dp": 4, "tp": 2}`` (insertion-ordered); raises
    ``ValueError`` on a malformed token or a duplicate axis."""
    axes: Dict[str, int] = {}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        m = _AXIS_RE.fullmatch(tok)
        if m is None:
            raise ValueError(
                f"bad mesh axis {tok!r} in spec {spec!r} — expected "
                f"<name><extent> tokens like 'dp4,tp2'")
        name, size = m.group(1), int(m.group(2))
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        if size < 1:
            raise ValueError(f"mesh axis {tok!r} must have extent >= 1")
        axes[name] = size
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


def axes_of(mesh=None) -> Dict[str, int]:
    """Ordered ``{axis: extent}`` for a spec string (``"dp4,tp2"``), an
    ``[[name, extent], ...]`` list, a dict, or ``None`` (the
    ``PADDLE_TPU_MESH`` spec; ``{}`` when unset)."""
    if mesh is None:
        from ..fluid import envcontract

        spec = envcontract.get("PADDLE_TPU_MESH")
        return parse_mesh_spec(spec) if spec else {}
    if isinstance(mesh, str):
        return parse_mesh_spec(mesh)
    if isinstance(mesh, dict):
        return {str(a): int(e) for a, e in mesh.items()}
    if isinstance(mesh, (list, tuple)):
        return {str(a): int(e) for a, e in mesh}
    raise TypeError(
        f"a mesh object ({type(mesh).__name__}) is not ported yet "
        f"(ROADMAP.md queue 1 item 12): pass a spec string such as "
        f"'dp4,tp2'")


def data_axis_extent(mesh) -> int:
    """The product of data-consuming axis extents of ``mesh`` (a
    ``"dp4,tp2"`` spec string, a list or dict of extents, or ``None`` for
    the ``PADDLE_TPU_MESH`` env spec).  1 when the mesh has no dp axis —
    a tp/mp-only mesh replicates the whole batch."""
    axes = axes_of(mesh)
    extent = 1
    for name in DATA_AXES:
        extent *= int(axes.get(name, 1))
    return extent


def shard_spec(mesh=None, host_rank: Optional[int] = None,
               num_hosts: Optional[int] = None) -> Tuple[int, int]:
    """This host's data shard for ``mesh``: ``(num_shards, shard_index)``.

    ``mesh`` as :func:`axes_of` takes it.  ``host_rank`` / ``num_hosts``
    default to a one-process world (rank 0 of 1).  With dp extent D over
    H hosts:

     - ``H == 1``      → ``(1, 0)``: one host feeds every dp group;
     - ``D % H == 0``  → ``(H, host_rank)``: each host owns D/H dp groups
       and reads a distinct 1/H of the data;
     - ``H % D == 0``  → ``(D, host_rank // (H // D))``: H/D hosts share
       each dp group and read IDENTICAL data (their devices split the
       batch along tp/fsdp, not along samples);
     - anything else is a layout error, raised by name rather than left
       to surface as silent sample overlap.

    Distinct shard indices partition the stream (``Pipeline.shard`` is
    round-robin), so no sample is read twice or lost across the fleet.
    """
    num_hosts = 1 if num_hosts is None else int(num_hosts)
    host_rank = 0 if host_rank is None else int(host_rank)
    if num_hosts < 1 or not 0 <= host_rank < num_hosts:
        raise ValueError(
            f"shard_spec: need 0 <= host_rank < num_hosts, got "
            f"rank={host_rank} of {num_hosts}")
    extent = data_axis_extent(mesh)
    if num_hosts == 1:
        return 1, 0
    if extent % num_hosts == 0:
        return num_hosts, host_rank
    if num_hosts % extent == 0:
        return extent, host_rank // (num_hosts // extent)
    raise ValueError(
        f"shard_spec: dp extent {extent} and host count {num_hosts} do "
        f"not tile (need one to divide the other) — mesh "
        f"{axes_of(mesh) or 'dp (default)'} cannot be fed by {num_hosts} "
        f"hosts without sample overlap")


def shard_layout(mesh, num_hosts: int) -> Dict[int, Tuple[int, int]]:
    """Every host's :func:`shard_spec` for one topology: ``rank ->
    (num_shards, shard_index)``.  Recorded into sharded-checkpoint meta at
    save time (by the sharded serial writer), so a resharded resume
    can group the per-rank cursor blobs by the shard stream they index
    without re-deriving the dead fleet's layout from env."""
    return {r: shard_spec(mesh, host_rank=r, num_hosts=int(num_hosts))
            for r in range(int(num_hosts))}


# ---------------------------------------------------------------------------
# Cursor remap: re-key committed per-rank pipeline cursors from
# one shard layout onto another, with no sample dropped or duplicated.
#
# Why a simple rule exists at all: ``Pipeline.shard(n, i)`` is a
# round-robin partition, and every rank commits its cursor at the SAME
# global step (one _SUCCESS covers the fleet), having consumed the same
# number k of its own shard's samples.  The union of what the fleet
# consumed is then EXACTLY the global-stream prefix [0, k*n) — so the
# remapped cursor for any new layout (m, j) is "shard stream (m, j)
# starting at global position k*n", which is one upstream state (the
# max-position donor's) plus a re-keyed shard filter.  dp4→dp2 merges two
# old streams (they interleave in fixed round-robin order past the cut);
# dp2→dp4 splits them; tp/fsdp peers collapse upstream via the
# ``shard_spec`` identical-data rule (the caller dedupes their blobs).
# ---------------------------------------------------------------------------


def _split_at_shard(state: dict):
    """Walk one pipeline-state tree outermost-stage first and split it at
    the shard node: ``(downstream_wrapper_nodes, shard_node_or_None)``."""
    node = state.get("stage")
    wrappers = []
    while isinstance(node, dict) and node.get("kind") != "shard":
        wrappers.append(node)
        node = node.get("up")
    return wrappers, (node if isinstance(node, dict) else None)


def _consumed_count(shard_index: int, num_shards: int, seen: int) -> int:
    """How many of its own samples shard ``shard_index`` has yielded when
    its upstream cursor sits at ``seen``.  The shard stage only commits
    right after yielding a kept sample (or before any), so ``seen`` is
    either 0 or ``(k-1)*n + i + 1`` — anything else is a torn cursor."""
    if seen == 0:
        return 0
    if (seen - 1) % num_shards != shard_index:
        raise ValueError(
            f"cursor for shard {shard_index}/{num_shards} sits at upstream "
            f"position {seen}, which is not a commit boundary of its own "
            f"stream (expected seen ≡ {shard_index + 1} mod {num_shards}) "
            f"— the blob is torn or from a different layout")
    return (seen - 1 - shard_index) // num_shards + 1


def merge_cursor_states(states_by_shard: Dict[int, dict],
                        new_num_shards: int,
                        new_shard_index: int) -> dict:
    """Re-key one shard stream's worth of committed cursors onto a new
    round-robin layout.

    ``states_by_shard`` maps every OLD shard index (0..n-1, tp/fsdp peers
    already collapsed to one blob each) to its committed ``Pipeline``
    state; the result restores into a pipeline built with
    ``shard(new_num_shards, new_shard_index)`` and the SAME upstream
    stages (source + any global shuffle — seed and buffer size included),
    positioned so the fleet's new shard streams cover exactly the samples
    the old fleet had not consumed.  Deterministic and pure: same blobs
    in, same cursor out, on every new rank.

    Raises ``ValueError`` (by name, never silently) when the layouts do
    not tile, a shard stream's blob is missing, the streams are not
    aligned at one global commit point, or the pipeline shuffles BELOW
    the shard stage (a per-shard shuffle permutes each rank's stream
    independently — there is no mesh-independent global order to cut)."""
    new_num_shards = int(new_num_shards)
    new_shard_index = int(new_shard_index)
    if new_num_shards < 1 or not 0 <= new_shard_index < new_num_shards:
        raise ValueError(
            f"merge_cursor_states: need 0 <= new_shard_index < "
            f"new_num_shards, got {new_shard_index} of {new_num_shards}")
    old_n = len(states_by_shard)
    if sorted(states_by_shard) != list(range(old_n)):
        raise ValueError(
            f"merge_cursor_states: need one cursor per old shard stream "
            f"0..{old_n - 1}, got indices {sorted(states_by_shard)} — a "
            f"missing stream would silently drop its unconsumed samples")
    if old_n == new_num_shards:
        # layout-preserving rank permutation: the stream itself transfers
        return copy.deepcopy(states_by_shard[new_shard_index])
    if old_n % new_num_shards != 0 and new_num_shards % old_n != 0:
        raise ValueError(
            f"merge_cursor_states: old shard count {old_n} and new shard "
            f"count {new_num_shards} do not tile (need one to divide the "
            f"other) — round-robin streams cannot be re-keyed without "
            f"sample overlap")

    split = {}
    epochs = set()
    wrapper_kinds = set()
    for i, st in states_by_shard.items():
        if not isinstance(st, dict) or "stage" not in st:
            raise ValueError(
                f"merge_cursor_states: shard {i}'s blob is not a pipeline "
                f"state (no 'stage' tree)")
        wrappers, shard_node = _split_at_shard(st)
        if shard_node is None:
            raise ValueError(
                f"merge_cursor_states: shard {i}'s cursor has no shard "
                f"stage — a layout change cannot be applied to an "
                f"unsharded pipeline state")
        for w in wrappers:
            if w.get("kind") == "shuffle":
                raise ValueError(
                    "merge_cursor_states: pipeline shuffles BELOW the "
                    "shard stage (shard(...).shuffle(...)), so each "
                    "rank's order is private to the old layout and "
                    "cannot be merged; build elastic pipelines as "
                    "from_reader(...).shuffle(...).shard_by_mesh(...) — "
                    "one global order, any mesh")
        split[i] = (wrappers, shard_node)
        epochs.add((int(st.get("epoch", 0)),
                    bool(st.get("epoch_done", False))))
        wrapper_kinds.add(tuple(w.get("kind") for w in wrappers))
    if len(epochs) > 1:
        raise ValueError(
            f"merge_cursor_states: shard cursors disagree on the epoch "
            f"{sorted(epochs)} — not one atomic fleet commit")
    if len(wrapper_kinds) > 1:
        raise ValueError(
            f"merge_cursor_states: shard cursors come from differently "
            f"shaped pipelines {sorted(wrapper_kinds)}")

    ks = {i: _consumed_count(i, old_n, int(sh.get("seen", 0)))
          for i, (_, sh) in split.items()}
    if len(set(ks.values())) != 1:
        raise ValueError(
            f"merge_cursor_states: shard streams are not aligned at one "
            f"global commit point (per-shard consumed counts {ks}) — the "
            f"blobs span different steps, or a short final batch was "
            f"committed unevenly")
    cut = ks[0] * old_n  # the fleet consumed exactly global prefix [0, cut)
    # the donor is the old stream whose upstream cursor sits exactly AT
    # the cut: with k samples consumed each, that is shard old_n-1 (its
    # k-th kept sample is global ordinal cut-1); every other stream's
    # upstream stopped short of the cut by < old_n skipped-not-mine
    # samples, all already consumed by later shards
    out = copy.deepcopy(states_by_shard[old_n - 1])
    _, shard_node = _split_at_shard(out)
    shard_node["seen"] = cut
    return out
