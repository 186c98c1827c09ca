"""The draft + verify tick (counterpart of
``paddle_tpu/serving/specdec/decoder.py``).

One spec tick replaces one plain engine tick:

::

    draft  x k+1 [S,1]-shaped draft-model steps over the draft's own
                 dense cache: k proposing d_1 .. d_k per slot, plus one
                 cache-fill step (proposal discarded) so a full accept
                 leaves no stale draft row
    tail   x 0|1 a plain step over every live slot when some slot is
                 too close to ``max_len`` to score k + 1 positions; only
                 those tail slots' tokens are kept.  It runs BEFORE the
                 verify: the step writes every lane (a dense cache has no
                 trash row), and a speculating lane's write lands on its
                 own frontier position, which the verify rewrites before
                 anything reads it
    verify x 1   ONE (k+1)-position target dispatch
                 (``DecodeModel.spec_program``): position j re-derives
                 exactly what sequential step j would, writes its K/V, and
                 ``spec_accept`` takes the longest draft == argmax prefix
                 plus the first correction token on the device
    commit       the engine consumes ``n + 1`` tokens per slot (n accepted
                 drafts), then rewinds the page pool to the committed
                 frontier: speculatively grown pages return through the
                 pool's single release path

Every committed token is a target argmax over a cache prefix identical to
sequential decode's, so churn, stalls and fallback change WHEN tokens
appear, never WHICH.  The executable set stays closed: the draft's step
and prefill buckets and the verify join the engine's graphs at
``warmup()``.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from .controller import SpecController
from .draft import DraftSource

__all__ = ["SpecDecoder"]


class SpecDecoder:
    """Speculative tick orchestration for one DecodeEngine.  Lives inside
    the engine's dispatch lock: the worker calls :meth:`run_tick` from
    ``_tick``, admission calls :meth:`prefill`.  No internal locking."""

    def __init__(self, engine, k: int, draft_layers: int,
                 min_accept: float, window: int):
        if int(k) < 1:
            raise ValueError(f"speculation depth must be >= 1, got {k}")
        self.engine = engine
        self.k = int(k)
        self.draft = DraftSource(engine.model, engine._exe, draft_layers)
        self.draft.sync(engine.scope)
        self.controller = SpecController(min_accept, window,
                                         metrics=engine.metrics)
        # position 0's logits are not fetched: no tick monitor reads them
        self._verify_prog, self._tok_fetch, self._nacc_fetch, _ = \
            engine.model.spec_program(self.k)
        # cumulative dispatch wall time (each dispatch ends synchronised),
        # draft against verify; the spec ticks' tail dispatches and the
        # tokens the spec ticks committed
        self.draft_s = 0.0
        self.verify_s = 0.0
        self.tail_ticks = 0
        self.tokens = 0

    # ------------------------------------------------------------------
    # admission + warmup + the draft phase
    # ------------------------------------------------------------------

    def prefill(self, slot: int, tokens: np.ndarray, bucket: int) -> None:
        """Write the prompt's K/V prefix into the DRAFT cache (the engine's
        ``_prefill`` hook).  Always dispatched, even when the target's
        prefill was a prefix-share full hit: the draft's cache shares
        nothing."""
        dm = self.draft.model
        self.engine._run(dm.prefill_program(bucket),
                         {dm.PF_TOKENS: tokens,
                          dm.PF_SLOT: np.asarray([slot], np.int64)},
                         [], scope=self.draft.scope)

    def warmup(self, ready) -> None:
        """Make the spec additions to the executable set ready: every draft
        prefill bucket, the draft step and the verify.  ``ready(dispatch)``
        repeats a dispatch until its program is one replay.  The caller
        (the engine's ``warmup``) holds the dispatch lock."""
        eng, dm = self.engine, self.draft.model
        s = eng.model.max_slots
        for b in dm.prefill_buckets:
            ready(lambda b=b: self.prefill(0, np.zeros((1, b), np.int64), b))
        ready(lambda: self._draft_step(np.zeros((s, 1), np.int64),
                                       np.zeros((s,), np.int64),
                                       np.zeros((s,), np.float32)))
        ready(lambda: self._dispatch_verify(self._idle_verify_feeds()))

    def _draft_step(self, tokens, pos, active) -> np.ndarray:
        dm = self.draft.model
        feeds = {dm.DC_TOKENS: tokens, dm.DC_POS: pos,
                 dm.DC_ACTIVE: active,
                 dm.DC_POSENC: dm.posenc_rows(pos).astype(np.float32),
                 dm.DC_BIAS: dm.validity_bias(pos)}
        (nxt,) = self.engine._run(dm.step_program, feeds, [dm.step_fetch],
                                  scope=self.draft.scope)
        # writable host copy: the poison drill rewrites drafted tokens
        return np.array(nxt, np.int64).reshape(-1)

    def _dispatch_verify(self, feeds):
        return self.engine._run(self._verify_prog, feeds,
                                [self._tok_fetch, self._nacc_fetch])

    def _idle_verify_feeds(self) -> dict:
        """All-inactive verify feeds (warmup): every write aims at the
        trash destination, every row is masked."""
        eng, model = self.engine, self.engine.model
        s, w = model.max_slots, self.k + 1
        trash = (eng._pool.trash_page if eng._pool is not None
                 else model.max_slots)
        feeds = {model.SP_DRAFT: np.zeros((s, self.k), np.int64),
                 model.SP_ACTIVE: np.zeros((s,), np.float32)}
        if eng._pool is not None:
            feeds[model.SP_PTABLE] = eng._pool.table()
        zero_pos = np.zeros((s,), np.int64)
        for j in range(w):
            feeds[model.SP_TOK.format(j)] = np.zeros((s, 1), np.int64)
            feeds[model.SP_PE.format(j)] = \
                model.posenc_rows(zero_pos).astype(np.float32)
            feeds[model.SP_BIAS_J.format(j)] = model.validity_bias(zero_pos)
            feeds[model.SP_WROW.format(j)] = np.full((s,), trash, np.int64)
            feeds[model.SP_WOFF.format(j)] = np.zeros((s,), np.int64)
        return feeds

    # ------------------------------------------------------------------
    # the spec tick
    # ------------------------------------------------------------------

    def run_tick(self) -> bool:
        """One draft + verify tick over the engine's slot table; False when
        this tick should run the plain path instead (fallback cooldown, or
        no slot has room to score k + 1 positions)."""
        from ...fluid import fault as _fault

        eng = self.engine
        if not self.controller.armed:
            # a plain tick is about to run; it counts toward the cooldown
            self.controller.note_plain_tick()
            return False
        model, k, w = eng.model, self.k, self.k + 1
        s = model.max_slots
        slots = list(eng._slots)
        # a slot speculates only when positions pos .. pos+k all fit the
        # cache; tail slots ride a plain step dispatch in this same tick
        eligible = [i for i, r in enumerate(slots)
                    if r is not None and int(r.pos) + k <= model.max_len - 1]
        if not eligible:
            return False
        tail = [i for i, r in enumerate(slots)
                if r is not None and i not in eligible]

        # -- draft: k proposing steps and one cache-fill step ----------
        t0 = time.perf_counter()
        tok0 = np.zeros((s, 1), np.int64)
        base = np.zeros((s,), np.int64)
        act = np.zeros((s,), np.float32)
        for i in eligible:
            r = slots[i]
            tok0[i, 0] = r.out_tokens[-1] if r.out_tokens else r.prompt[-1]
            base[i] = int(r.pos)
            act[i] = 1.0
        poison_from = _fault.spec_draft_poison()
        poisoned = poison_from is not None and eng._ticks >= poison_from
        drafted = np.zeros((s, k), np.int64)
        cur = tok0.copy()
        for j in range(k):
            nxt = self._draft_step(cur, base + j, act)
            if poisoned:
                # deterministic garbage, valid vocab ids: acceptance
                # collapses, the controller trips, and every committed
                # token is still a target argmax
                for i in eligible:
                    nxt[i] = (int(base[i]) + 31 * j + 7 * i) \
                        % model.vocab_size
            drafted[:, j] = nxt
            cur = nxt.reshape(s, 1)
        # the proposal of this step is discarded: a FULL accept commits
        # k + 1 tokens, so the draft cache needs row base+k (token d_k)
        # before the next tick's attention reads it
        self._draft_step(cur, base + k, act)
        self.draft_s += time.perf_counter() - t0

        # -- tail: a plain step over every live slot, before the verify.
        # A None lane would write token 0 at position 0 of its dense
        # cache row, a live speculating slot's committed prefix; as a
        # live lane it writes its frontier position instead, which the
        # verify rewrites.  Only the tail slots' tokens are kept.
        tail_nxt, tail_stalled = None, set()
        if tail:
            tail_nxt, tail_stalled, _ = eng._step_dispatch(
                slots, count_tick=False)
            self.tail_ticks += 1

        # -- verify: one (k+1)-position target dispatch ----------------
        t1 = time.perf_counter()
        pool = eng._pool
        trash = pool.trash_page if pool is not None else model.max_slots
        wrow = [np.full((s,), trash, np.int64) for _ in range(w)]
        woff = [np.zeros((s,), np.int64) for _ in range(w)]
        n_cap: Dict[int, int] = {}
        stalled = set()
        if pool is not None:
            for i in eligible:
                p = int(base[i])
                covered = 0
                for j in range(w):
                    if not pool.ensure(i, p + j):
                        break  # pool dry: rows >= j write trash, and
                    covered += 1  # acceptance is capped below them
                if covered == 0:
                    stalled.add(i)  # not even the first write fits:
                    continue        # the slot stalls as in a plain tick
                n_cap[i] = covered - 1
                for j in range(covered):
                    wrow[j][i], woff[j][i] = pool.write_loc(i, p + j)
        else:
            for i in eligible:
                p = int(base[i])
                n_cap[i] = k
                for j in range(w):
                    wrow[j][i], woff[j][i] = i, p + j
        act2 = act.copy()
        for i in stalled:
            act2[i] = 0.0
        feeds = {model.SP_DRAFT: drafted, model.SP_ACTIVE: act2}
        if pool is not None:
            feeds[model.SP_PTABLE] = pool.table()
        for j in range(w):
            tok_j = np.zeros((s, 1), np.int64)
            for i in eligible:
                if i not in stalled:
                    tok_j[i, 0] = tok0[i, 0] if j == 0 \
                        else drafted[i, j - 1]
            pos_j = np.where(act2 > 0, base + j, 0)
            feeds[model.SP_TOK.format(j)] = tok_j
            feeds[model.SP_PE.format(j)] = \
                model.posenc_rows(pos_j).astype(np.float32)
            feeds[model.SP_BIAS_J.format(j)] = model.validity_bias(pos_j)
            feeds[model.SP_WROW.format(j)] = wrow[j]
            feeds[model.SP_WOFF.format(j)] = woff[j]
        toks, nacc = self._dispatch_verify(feeds)
        t2 = time.perf_counter()
        self.verify_s += t2 - t1

        # -- commit: the accepted prefix and the correction per slot ---
        eng._ticks += 1
        eng.metrics.inc("decode_ticks")
        eng.metrics.inc("spec_ticks")
        sample: Dict[int, Tuple[int, int]] = {}
        for i in eligible:
            req = slots[i]
            if i in stalled:
                eng._stall_expire(i, req, t2)
                continue
            n = min(int(nacc[i]), n_cap[i])
            sample[i] = (n, k)
            eng.metrics.inc("spec_draft_tokens", k)
            eng.metrics.inc("spec_accepted_tokens", n)
            for j in range(n + 1):
                self.tokens += 1
                if eng._consume(i, req, int(toks[i, j]), t2):
                    break  # retired: _retire released every page
            else:
                if pool is not None:
                    # rejected speculative growth rewinds to the committed
                    # frontier (req.pos is the next write)
                    pool.rewind(i, int(req.pos))
        for i in tail:
            req = slots[i]
            if i in tail_stalled:
                eng._stall_expire(i, req, t2)
                continue
            self.tokens += 1
            eng._consume(i, req, int(tail_nxt[i]), t2)
        if sample:
            self.controller.observe(sample)
        return True
