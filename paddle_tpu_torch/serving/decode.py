"""Continuous batching for autoregressive decode (counterpart of
``paddle_tpu/serving/decode.py``).

 - **Slot-based KV cache**: per-layer K/V caches live on the device in the
   engine's scope across dispatches; the executor updates them in place.
   A request owns one slot from admission to retirement.
 - **Iteration-level scheduling**: every engine tick runs ONE decode step
   over ALL slots at fixed ``[max_slots, ...]`` shapes.  New requests enter
   free slots mid-flight through a bucketed prefill that writes their K/V
   prefix; finished slots retire at once, so a short request's latency is
   O(own length), not O(longest cohabitant).
 - **Worker loop**: ``admit -> step -> retire`` on one thread that owns
   every dispatch.

Correctness contract: the decode step is row-independent over the slot
dim and masks stale cache positions with EXACT ``-inf`` bias, so a
stream's tokens are bitwise those of per-request sequential decode
(:meth:`DecodeEngine.decode_static` with one request) — continuous
batching is purely a scheduling change.

Paged KV cache: when the model was built paged, the per-layer caches are
``[num_pages + 1, page_size, d_model]`` page pools and the engine drives
a host-side :class:`~.kvpool.PagePool`: admission allocates pages (or
re-queues the request when the pool is dry), decode growth allocates one
page per ``page_size`` ticks (a dry pool stalls the slot for one tick the
output cannot see), every retirement returns pages, and full prompt pages
are shared across requests with a common prefix (full hits skip the
prefill dispatch).  Each decode tick runs the paged-attention kernel once
per layer.

Entry points run on the card (``CUDAPlace(0)``) unless the caller passes
another place; with no place and no CUDA device the engine raises.

Not in this slice: speculative decoding (``spec > 0`` raises), hot model
swap, the tick monitor, the compile-cache manifest and trace spans.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .engine import (DrainTimeout, EngineClosed, EngineOverloaded,
                     RequestTimeout, _Request)
from .metrics import ServingMetrics

__all__ = ["DecodeConfig", "DecodeEngine", "create_decode_engine"]


@dataclass
class DecodeConfig:
    """Scheduling policy for a :class:`DecodeEngine` (the shape knobs live
    on the model).

    ``max_queue_depth``    pending requests beyond this shed with
                           :class:`EngineOverloaded`;
    ``default_timeout_ms`` per-request deadline when submit() gets none,
                           checked per token;
    ``idle_wait_s``        worker-condition wait while fully idle;
    ``spec``               speculation depth; None reads
                           ``PADDLE_SERVE_SPEC``.  Only 0 is carried.
    """
    max_queue_depth: int = 256
    default_timeout_ms: Optional[float] = None
    idle_wait_s: float = 0.05
    spec: Optional[int] = None


class DecodeEngine:
    """Iteration-level-scheduled greedy generation over one step-form
    decode model (:class:`paddle_tpu_torch.models.transformer.DecodeModel`).

    ``submit(prompt_ids, max_new_tokens)`` returns a Future of the
    generated token-id list (ends at the model's ``end_id``, the token
    budget, or cache capacity).  Use as a context manager or call
    ``shutdown()``."""

    def __init__(self, model=None, config: Optional[DecodeConfig] = None,
                 place=None):
        from ..fluid import core as _core
        from ..fluid import envcontract as _ec
        from ..fluid.executor import Executor, Scope

        if not _ec.get("PADDLE_SERVE_DECODE"):
            raise EngineClosed("continuous-batching decode is disabled "
                               "(PADDLE_SERVE_DECODE=0)")
        self.config = config or DecodeConfig()
        spec_k = (self.config.spec if self.config.spec is not None
                  else int(_ec.get("PADDLE_SERVE_SPEC") or 0))
        if spec_k > 0:
            raise NotImplementedError(
                "speculative decoding is not ported to paddle_tpu_torch "
                "yet; use spec=0")
        # the executor resolves the place first: with no place and no
        # CUDA device this raises before anything else is built
        self._exe = Executor(place if place is not None
                             else _core.CUDAPlace(0))
        if model is None:
            from ..models.transformer import DecodeModel

            model = DecodeModel()
        self.model = model
        self.metrics = ServingMetrics()
        self._scope = Scope()
        self._exe.run(model.startup, scope=self._scope)
        self._pool = None
        if getattr(model, "paged", False):
            from .kvpool import PagePool

            page_bytes = (model.page_size * model.cfg.d_model * 4
                          * 2 * model.cfg.n_layer)
            self._pool = PagePool(
                model.num_pages, model.page_size, model.pages_per_slot,
                model.max_slots, page_bytes=page_bytes,
                prefix_share=bool(_ec.get("PADDLE_SERVE_PREFIX_SHARE")),
                metrics=self.metrics)
        self._cond = threading.Condition(threading.Lock())
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[_Request]] = [None] * model.max_slots
        self._n_active = 0
        self._draining = False
        self._stopped = False
        self._rid = itertools.count()
        # serializes every dispatch: the worker holds it per iteration,
        # warmup()/decode_static() take it between iterations
        self._dispatch_lock = threading.Lock()
        self.metrics.note_slots(0, model.max_slots)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-worker")
        self._worker.start()

    @property
    def scope(self):
        """The engine's scope: weights and KV caches by name."""
        return self._scope

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int,
               timeout_ms: Optional[float] = None) -> Future:
        """Enqueue one generation request; returns a Future of the
        generated token ids (list of int, excluding the prompt)."""
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.model.vocab_size for t in prompt):
            raise ValueError(f"prompt token out of vocab range "
                             f"[0, {self.model.vocab_size})")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.model.bucket_for(len(prompt)) is None:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest "
                f"prefill bucket ({self.model.prefill_buckets[-1]})")
        if len(prompt) + max_new > self.model.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceed the KV-cache capacity "
                f"(max_len {self.model.max_len})")
        if timeout_ms is None:
            timeout_ms = self.config.default_timeout_ms
        now = time.perf_counter()
        fut: Future = Future()
        req = _Request(fut, now + timeout_ms / 1000.0 if timeout_ms
                       else None, now)
        req.prompt, req.max_new, req.out_tokens = prompt, max_new, []
        req.rid = f"d{next(self._rid)}"
        with self._cond:
            if self._stopped or self._draining:
                raise EngineClosed("decode engine is draining/stopped")
            if len(self._queue) >= self.config.max_queue_depth:
                self.metrics.inc("shed")
                raise EngineOverloaded(
                    f"decode queue full ({self.config.max_queue_depth} "
                    f"pending); request shed")
            self._queue.append(req)
            self.metrics.inc("submitted")
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self._cond.notify()
        return fut

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 timeout_ms: Optional[float] = None) -> List[int]:
        """Blocking submit."""
        return self.submit(prompt_ids, max_new_tokens,
                           timeout_ms=timeout_ms).result()

    # ------------------------------------------------------------------
    # the worker loop: admit -> step -> retire
    # ------------------------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while not self._n_active and not self._stopped \
                        and not self._queue:
                    self._cond.wait(self.config.idle_wait_s)
                if self._stopped:
                    break
            with self._dispatch_lock:
                self._reap_abandoned()
                self._admit()
                if self._n_active:
                    self._tick()
            with self._cond:
                self._cond.notify_all()  # drain() watches progress
        self._fail_leftovers()

    def _reap_abandoned(self):
        """Free slots whose futures were resolved from outside the worker
        (the bounded-drain timeout fails stuck futures)."""
        for i, r in enumerate(self._slots):
            if r is not None and r.future.done():
                self._slots[i] = None
                self._n_active -= 1
                if self._pool is not None:
                    self._pool.release(i)
        self.metrics.note_slots(self._n_active,
                                self.model.max_slots - self._n_active)

    def _fail_leftovers(self):
        """Worker exit with work still resident: fail those futures."""
        leftovers = [r for r in self._slots if r is not None]
        if self._pool is not None:
            for i, r in enumerate(self._slots):
                if r is not None:
                    self._pool.release(i)
        self._slots = [None] * self.model.max_slots
        self._n_active = 0
        with self._cond:
            leftovers += list(self._queue)
            self._queue.clear()
        for r in leftovers:
            if not r.future.done():
                self.metrics.inc("failed")
                r.future.set_exception(EngineClosed("decode engine stopped"))

    def _admit(self):
        """Fill free slots from the queue: one bucketed prefill dispatch
        per admitted request writes its K/V prefix."""
        while True:
            free = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if free is None:
                return
            req = None
            with self._cond:
                while self._queue:
                    cand = self._queue.popleft()
                    now = time.perf_counter()
                    if cand.deadline is not None and now > cand.deadline:
                        self.metrics.inc("expired")
                        cand.future.set_exception(RequestTimeout(
                            f"deadline expired after "
                            f"{(now - cand.t_submit) * 1e3:.1f} ms in "
                            f"queue"))
                        continue
                    req = cand
                    break
                self.metrics.set_gauge("queue_depth", len(self._queue))
                if req is not None:
                    # reserve the slot under _cond so the bounded-drain
                    # abort (which scans queue + slots) always sees req
                    self._slots[free] = req
                    self._n_active += 1
            if req is None:
                return
            if self._pool is not None:
                grant = self._pool.admit(
                    free, req.prompt, self.model.bucket_for(len(req.prompt)))
                if grant is None:
                    # not enough free pages: back to the head of the queue;
                    # resident streams free pages as they retire
                    with self._cond:
                        self._slots[free] = None
                        self._n_active -= 1
                        self._queue.appendleft(req)
                        self.metrics.inc("page_requeues")
                        self.metrics.set_gauge("queue_depth",
                                               len(self._queue))
                        idle = self._n_active == 0
                    if idle:
                        # nothing will retire pages: don't spin on the pool
                        time.sleep(self.config.idle_wait_s)
                    return
                req.grant = grant
            self._prefill(req, free)

    def _run_prefill(self, prompt, slot, grant) -> bool:
        """One admitted request's bucketed prefill dispatch (after its
        pages were granted).  Skipped on a full prefix hit, where every
        page it would write is already resident; on a PARTIAL hit it runs,
        since rewriting a shared page with the same (bucket, prefix)
        content is idempotent.  Returns True when it dispatched."""
        if grant is not None and grant.full_hit:
            return False
        model = self.model
        bucket = model.bucket_for(len(prompt))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(prompt)] = prompt
        feeds = {model.PF_TOKENS: tokens}
        if self._pool is not None:
            feeds[model.PF_PAGES] = self._pool.prefill_pages(slot, bucket)
        else:
            feeds[model.PF_SLOT] = np.asarray([slot], np.int64)
        self._run(model.prefill_program(bucket), feeds, [])
        return True

    def _prefill(self, req: _Request, slot: int):
        if self._run_prefill(req.prompt, slot, req.grant):
            self.metrics.inc("prefills")
        else:
            self.metrics.inc("prefill_skips")
        # the first decode tick re-derives position plen-1 (same token,
        # same weights => bit-identical K/V) and emits the first token
        req.pos = len(req.prompt) - 1
        self.metrics.note_slots(self._n_active,
                                self.model.max_slots - self._n_active)

    def _tick_feeds(self, slots):
        """Fixed-shape decode-step feeds off a slot table.  Returns
        ``(feeds, stalled)``: in paged mode a slot whose cache growth found
        the pool dry STALLS this tick — its active flag drops, its write
        aims at the trash page and the caller discards its token."""
        model = self.model
        s = model.max_slots
        tokens = np.zeros((s, 1), np.int64)
        pos = np.zeros((s,), np.int64)
        active = np.zeros((s,), np.float32)
        stalled = set()
        if self._pool is not None:
            wpage = np.full((s,), self._pool.trash_page, np.int64)
            woff = np.zeros((s,), np.int64)
        for i, r in enumerate(slots):
            if r is None:
                continue
            if self._pool is not None:
                if not self._pool.ensure(i, int(r.pos)):
                    stalled.add(i)
                    continue  # active stays 0: masked like a free slot
                wpage[i], woff[i] = self._pool.write_loc(i, int(r.pos))
            active[i] = 1.0
            tokens[i, 0] = (r.out_tokens[-1] if r.out_tokens
                            else r.prompt[-1])
            pos[i] = r.pos
        feeds = {model.DC_TOKENS: tokens, model.DC_POS: pos,
                 model.DC_ACTIVE: active,
                 model.DC_POSENC: model.posenc_rows(pos).astype(np.float32),
                 model.DC_BIAS: model.validity_bias(pos)}
        if self._pool is not None:
            feeds[model.DC_PTABLE] = self._pool.table()
            feeds[model.DC_WPAGE] = wpage
            feeds[model.DC_WOFF] = woff
        return feeds, stalled

    def _step_dispatch(self, slots):
        """ONE decode step over all slots; returns the [S] next tokens,
        the set of paged slots that stalled this tick, and the [S, V]
        logits."""
        feeds, stalled = self._tick_feeds(slots)
        nxt, logits = self._run(self.model.step_program, feeds,
                                [self.model.step_fetch,
                                 self.model.logits_fetch])
        self.metrics.inc("decode_ticks")
        return nxt.reshape(-1), stalled, logits

    def _consume(self, i: int, req: _Request, tok: int, t1: float) -> bool:
        """Commit ONE generated token to slot ``i``: latency observations,
        retirement on end_id / token budget / cache capacity, the
        per-token deadline.  Returns True when the request retired."""
        model = self.model
        req.out_tokens.append(tok)
        req.pos += 1
        self.metrics.inc("tokens_generated")
        if len(req.out_tokens) == 1:
            self.metrics.observe_ttft(t1 - req.t_submit)
        else:
            self.metrics.observe_intertoken(t1 - req.t_prev_token)
        req.t_prev_token = t1
        if (tok == model.end_id or len(req.out_tokens) >= req.max_new
                or req.pos >= model.max_len):
            self._retire(i)
            return True
        if req.deadline is not None and t1 > req.deadline:
            self._retire(i, error=RequestTimeout(
                f"deadline expired after {len(req.out_tokens)} "
                f"generated tokens"))
            return True
        return False

    def _tick(self):
        nxt, stalled, _ = self._step_dispatch(self._slots)
        t1 = time.perf_counter()
        for i, req in enumerate(list(self._slots)):
            if req is None:
                continue
            if i in stalled:
                # pool-dry stall: the token is discarded and pos keeps; an
                # expired staller must still retire and return its pages
                if req.deadline is not None and t1 > req.deadline:
                    self._retire(i, error=RequestTimeout(
                        f"deadline expired after {len(req.out_tokens)} "
                        f"generated tokens (pool-stalled)"))
                continue
            self._consume(i, req, int(nxt[i]), t1)

    def _retire(self, slot: int, error: Optional[Exception] = None):
        req = self._slots[slot]
        self._slots[slot] = None
        self._n_active -= 1
        if self._pool is not None:
            # pages return on EVERY retirement path; shared prefix pages
            # survive until their last holder
            self._pool.release(slot)
        self.metrics.note_slots(self._n_active,
                                self.model.max_slots - self._n_active)
        if req.future.done():
            return  # failed externally (bounded-drain timeout)
        if error is not None:
            self.metrics.inc("expired" if isinstance(error, RequestTimeout)
                             else "failed")
            req.future.set_exception(error)
            return
        self.metrics.inc("completed")
        self.metrics.observe_latency(time.perf_counter() - req.t_submit)
        req.future.set_result(list(req.out_tokens))

    # ------------------------------------------------------------------
    # dispatch plumbing + warmup
    # ------------------------------------------------------------------

    def _run(self, program, feed, fetch_list):
        return self._exe.run(program, feed=feed, fetch_list=fetch_list,
                             scope=self._scope)

    def warmup(self) -> None:
        """Run every program once — each prefill bucket against the trash
        page (or slot 0 when dense) and one all-idle decode step — so the
        first request pays no first-call costs (kernel build and load,
        allocator growth).  The writes land nowhere a stream reads."""
        model = self.model
        with self._dispatch_lock:
            for b in model.prefill_buckets:
                feeds = {model.PF_TOKENS: np.zeros((1, b), np.int64)}
                if self._pool is not None:
                    feeds[model.PF_PAGES] = np.full(
                        (b // model.page_size,), self._pool.trash_page,
                        np.int64)
                else:
                    feeds[model.PF_SLOT] = np.zeros((1,), np.int64)
                self._run(model.prefill_program(b), feeds, [])
                self.metrics.inc("warmup_dispatches")
            self._step_dispatch([None] * model.max_slots)
            self.metrics.inc("warmup_dispatches")

    # ------------------------------------------------------------------
    # static-batching baseline (the sequential-equivalence comparator)
    # ------------------------------------------------------------------

    def decode_static(self, batch: Sequence[Tuple[Sequence[int], int]]
                      ) -> List[Tuple[List[int], float]]:
        """Request-granularity batching over the SAME model: admit the
        whole batch, tick until EVERY member finishes, resolve all at batch
        end.  A one-request batch is the per-request sequential baseline.
        Returns ``[(tokens, latency_s), ...]``; only callable while the
        engine is otherwise idle."""
        model = self.model
        if len(batch) > model.max_slots:
            raise ValueError(f"static batch ({len(batch)}) exceeds "
                             f"max_slots ({model.max_slots})")
        with self._dispatch_lock:
            if self._n_active or self._queue:
                raise RuntimeError("decode_static requires an idle engine")
            slots: List[Optional[_Request]] = [None] * model.max_slots
            t_start = []
            admitted: List[int] = []
            try:
                for i, (prompt, max_new) in enumerate(batch):
                    t0 = time.perf_counter()
                    req = _Request(Future(), None, t0)
                    req.prompt = [int(t) for t in prompt]
                    req.max_new = int(max_new)
                    req.out_tokens = []
                    if self._pool is not None:
                        req.grant = self._pool.admit(
                            i, req.prompt, model.bucket_for(len(req.prompt)))
                        if req.grant is None:
                            raise RuntimeError(
                                f"page pool cannot admit static batch "
                                f"member {i} "
                                f"({self._pool.pages_free} pages free)")
                        admitted.append(i)
                    self._run_prefill(req.prompt, i, req.grant)
                    req.pos = len(req.prompt) - 1
                    slots[i] = req
                    t_start.append(t0)
                finished = [False] * len(batch)
                while not all(finished):
                    live = [r if r is not None and not finished[j] else None
                            for j, r in enumerate(slots)]
                    nxt, stalled, _ = self._step_dispatch(live)
                    progressed = False
                    for j, req in enumerate(slots[:len(batch)]):
                        if finished[j] or j in stalled:
                            continue
                        progressed = True
                        tok = int(nxt[j])
                        req.out_tokens.append(tok)
                        req.pos += 1
                        finished[j] = (tok == model.end_id
                                       or len(req.out_tokens) >= req.max_new
                                       or req.pos >= model.max_len)
                        if finished[j] and self._pool is not None:
                            self._pool.release(j)
                            admitted.remove(j)
                    if not progressed:
                        raise RuntimeError(
                            "page pool exhausted with the whole static "
                            "batch resident — no retirement can free "
                            "pages; use a smaller batch or more pages")
                t_end = time.perf_counter()
                return [(list(slots[j].out_tokens), t_end - t_start[j])
                        for j in range(len(batch))]
            finally:
                if self._pool is not None:
                    for j in admitted:
                        self._pool.release(j)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Wait until no request is queued or resident.  Returns False on
        timeout."""
        deadline = time.perf_counter() + timeout_s
        with self._cond:
            while self._n_active or self._queue:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting; wait until every queued and resident request
        has resolved.  On expiry every outstanding future fails with
        :class:`DrainTimeout` naming the stuck request ids."""
        deadline = time.perf_counter() + timeout_s
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._queue or self._n_active:
                left = deadline - time.perf_counter()
                if left <= 0:
                    self._abort_outstanding_locked("drain")
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def _abort_outstanding_locked(self, what: str) -> None:
        """Fail every queued + resident future with DrainTimeout (caller
        holds ``_cond``); the worker reaps the resident slots."""
        stuck = list(self._queue) + [r for r in self._slots
                                     if r is not None
                                     and not r.future.done()]
        self._queue.clear()
        self.metrics.set_gauge("queue_depth", 0)
        if not stuck:
            return
        ids = [r.rid for r in stuck]
        exc = DrainTimeout(
            f"{what} timed out after {len(ids)} outstanding decode "
            f"request(s): {', '.join(ids)}", ids)
        for r in stuck:
            self.metrics.inc("failed")
            if not r.future.done():
                r.future.set_exception(exc)

    def shutdown(self, timeout_s: float = 60.0) -> bool:
        ok = self.drain(timeout_s=timeout_s)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def create_decode_engine(cfg=None, config: Optional[DecodeConfig] = None,
                         place=None, **model_kwargs) -> DecodeEngine:
    """A DecodeEngine over a fresh step-form decode model.  ``cfg`` is a
    transformer Config (default: the CPU-test-scale decode LM);
    ``model_kwargs`` forward to DecodeModel."""
    from ..models.transformer import DecodeModel

    return DecodeEngine(DecodeModel(cfg=cfg, **model_kwargs), config,
                        place=place)
