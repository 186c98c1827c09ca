"""Host-side page-pool allocator + prefix-sharing index (counterpart of
``paddle_tpu/serving/kvpool/pool.py``).

The device side of the paged KV cache is a plain tensor per layer: one
``[num_pages + 1, page_size, d_model]`` K and V pool whose last row is the
TRASH page (inactive-slot decode writes, prefill pad pages and unmapped
page-table entries all land there; the exact ``-inf`` validity bias keeps
its contents out of every output bit).  All allocation policy lives here,
in host data structures the engine mutates under its dispatch lock:

 - **free list**: an admission allocates ``(plen - 1) // page_size + 1``
   pages (the last is always slot-private; decode growth adds one at a
   time) and retirement returns them.  ``admit`` returns None when the
   pool cannot cover a request (the engine re-queues it) and ``ensure``
   returns False when growth finds the pool dry (the slot stalls one tick,
   which the output stream cannot see).
 - **prefix sharing**: every FULL prompt page (all of its positions
   ``< plen - 1``, so decode writes never touch it) is published in an
   exact-match index keyed by ``(bucket, prompt-prefix-tokens)`` and shared
   read-only, refcounted, across slots.  The key carries the prefill bucket
   so a hit's resident K/V is bitwise what this request's own prefill would
   write.  When every shareable page hits and the private page would start
   empty, the engine skips the prefill dispatch.
 - **accounting**: every mutation republishes the ``kvpool_*`` gauges
   into the engine's :class:`~..metrics.ServingMetrics`.

Thread-safety: one internal lock; ``table()`` returns a fresh copy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PageGrant", "PagePool"]


@dataclass
class PageGrant:
    """One admission's page set.  ``pages[:hits]`` came refcount-shared
    from the prefix index; the rest are freshly allocated (the last one is
    always slot-private).  ``full_hit`` means every prompt position the
    prefill would write below ``plen - 1`` is already resident, so the
    engine may skip the prefill dispatch."""
    slot: int
    pages: List[int]
    hits: int
    full_hit: bool


class PagePool:
    """Allocator + prefix index over ``num_pages`` device pages.

    ``page_bytes`` is the device memory of ONE page across K+V and all
    layers (``page_size * d_model * 4 bytes * 2 * n_layer``), used only for
    gauges.  ``metrics`` receives the ``prefix_hits`` counter and the
    ``kvpool_*`` gauges."""

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int,
                 max_slots: int, page_bytes: int = 0,
                 prefix_share: bool = True, metrics=None):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.max_slots = int(max_slots)
        self.page_bytes = int(page_bytes)
        self.prefix_share = bool(prefix_share)
        self.trash_page = self.num_pages
        self._metrics = metrics
        self._lock = threading.Lock()
        # LIFO free list: pop() from the end => low page ids stay hot and
        # allocation order is deterministic
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._slot_pages: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}
        self._index: Dict[tuple, int] = {}   # (bucket, prefix) -> page
        self._page_key: Dict[int, tuple] = {}
        self._publish_locked()

    # -- queries -----------------------------------------------------------

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_live(self) -> int:
        with self._lock:
            return self.num_pages - len(self._free)

    @property
    def pages_leaked(self) -> int:
        """Pages neither free nor held by any slot: the frees the page-leak
        fault oracle (``PADDLE_FAULT_KV_PAGE_LEAK``, ``fluid.fault.
        kv_page_leak``) made the pool skip, and any page a release path
        lost: what the free list and the slots' page lists miss."""
        with self._lock:
            held = {p for pages in self._slot_pages.values() for p in pages}
            return self.num_pages - len(self._free) - len(held)

    def slot_pages(self, slot: int) -> List[int]:
        with self._lock:
            return list(self._slot_pages.get(slot, ()))

    def table(self) -> np.ndarray:
        """The per-tick ``[max_slots, pages_per_slot]`` page-table feed:
        each slot's owned pages in position order, trash elsewhere."""
        with self._lock:
            t = np.full((self.max_slots, self.pages_per_slot),
                        self.trash_page, np.int64)
            for slot, pages in self._slot_pages.items():
                t[slot, :len(pages)] = pages
            return t

    def write_loc(self, slot: int, pos: int) -> Tuple[int, int]:
        """(page, offset) for this slot's decode write at ``pos``; call
        only after :meth:`ensure` returned True for the position."""
        with self._lock:
            pages = self._slot_pages[slot]
            return pages[pos // self.page_size], pos % self.page_size

    # -- allocate ----------------------------------------------------------

    def _prefix_key(self, bucket: int, prompt, j: int) -> tuple:
        return (int(bucket), tuple(prompt[:(j + 1) * self.page_size]))

    def admit(self, slot: int, prompt, bucket: int) -> Optional[PageGrant]:
        """Allocate the admission page set for ``prompt`` into ``slot``;
        None = not enough free pages (the engine re-queues the request).
        Full prompt pages already in the index are attached by refcount
        instead of allocated."""
        ps = self.page_size
        plen = len(prompt)
        f_share = (plen - 1) // ps  # full pages, all positions < plen-1
        with self._lock:
            hits: List[int] = []
            if self.prefix_share:
                # keys are full-prefix tuples, so hits form a prefix chain
                for j in range(f_share):
                    page = self._index.get(
                        self._prefix_key(bucket, prompt, j))
                    if page is None:
                        break
                    hits.append(page)
            fresh = (f_share + 1) - len(hits)
            if fresh > len(self._free):
                return None
            for page in hits:
                self._ref[page] += 1
            pages = list(hits)
            for j in range(len(hits), f_share + 1):
                page = self._free.pop()
                self._ref[page] = 1
                pages.append(page)
                if self.prefix_share and j < f_share:
                    key = self._prefix_key(bucket, prompt, j)
                    self._index[key] = page
                    self._page_key[page] = key
            self._slot_pages[slot] = pages
            full_hit = bool(self.prefix_share and f_share > 0
                            and len(hits) == f_share
                            and (plen - 1) % ps == 0)
            self._publish_locked()
        if hits and self._metrics is not None:
            self._metrics.inc("prefix_hits", len(hits))
        return PageGrant(slot=int(slot), pages=pages, hits=len(hits),
                         full_hit=full_hit)

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow the slot's page list to cover a decode write at ``pos``;
        False = pool dry (the slot stalls this tick: the engine aims its
        write at the trash page, masks its token and retries next tick)."""
        with self._lock:
            pages = self._slot_pages.get(slot)
            if pages is None:
                return False
            if pos // self.page_size < len(pages):
                return True
            if not self._free:  # need == len(pages): grow by exactly one
                return False
            page = self._free.pop()
            self._ref[page] = 1
            pages.append(page)
            self._publish_locked()
            return True

    def prefill_pages(self, slot: int, bucket: int) -> np.ndarray:
        """The ``[bucket // page_size]`` int64 PF_PAGES feed: the slot's
        owned pages, then trash for bucket pad pages beyond them."""
        n = int(bucket) // self.page_size
        out = np.full((n,), self.trash_page, np.int64)
        with self._lock:
            pages = self._slot_pages.get(slot, ())
            k = min(n, len(pages))
            out[:k] = pages[:k]
        return out

    # -- release -----------------------------------------------------------

    def _drop_page_locked(self, page: int) -> int:
        """The single page-release path: refcount decrement, prefix-index
        eviction at zero, then the free, unless the page-leak fault oracle
        skips it (the page then never returns).  Returns pages actually
        freed (0 for a page still shared or leaked)."""
        from ...fluid import fault as _fault

        self._ref[page] -= 1
        if self._ref[page] > 0:
            return 0
        del self._ref[page]
        key = self._page_key.pop(page, None)
        # evict the prefix entry only if it still names this page
        if key is not None and self._index.get(key) == page:
            del self._index[key]
        if _fault.kv_page_leak():
            return 0  # the skipped free: the page never returns
        self._free.append(page)
        return 1

    def release(self, slot: int) -> int:
        """Return the slot's pages (retire, deadline expiry, reap, static
        teardown).  Shared pages reach the free list only at refcount zero.
        Returns the number of pages actually freed."""
        freed = 0
        with self._lock:
            pages = self._slot_pages.pop(slot, None)
            if pages is None:
                return 0
            for page in pages:
                freed += self._drop_page_locked(page)
            self._publish_locked()
        return freed

    def rewind(self, slot: int, keep_pos: int) -> int:
        """Shrink the slot's page list to exactly cover positions
        ``<= keep_pos`` (speculative rollback): pages grown for rejected
        draft positions return through the single release path.  The page
        holding ``keep_pos`` is always kept.  Returns the number of pages
        actually freed."""
        freed = 0
        with self._lock:
            pages = self._slot_pages.get(slot)
            if pages is None:
                return 0
            keep = int(keep_pos) // self.page_size + 1
            while len(pages) > keep:
                freed += self._drop_page_locked(pages.pop())
            if freed:
                self._publish_locked()
        return freed

    def flush_index(self) -> None:
        """Drop every prefix entry (a weight swap: resident page content no
        longer matches what a NEW admission's prefill would write).
        Holders keep their refcounts; pages just stop being
        discoverable."""
        with self._lock:
            self._index.clear()
            self._page_key.clear()

    # -- accounting --------------------------------------------------------

    def _publish_locked(self) -> None:
        if self._metrics is None:
            return
        free = len(self._free)
        live = self.num_pages - free
        self._metrics.set_gauge("kvpool_pages_free", free)
        self._metrics.set_gauge("kvpool_pages_live", live)
        self._metrics.set_gauge("kvpool_hbm_bytes", live * self.page_bytes)
        self._metrics.set_gauge("kvpool_pool_bytes",
                                (self.num_pages + 1) * self.page_bytes)
