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

Speculative decoding (``DecodeConfig(spec=k)`` or ``PADDLE_SERVE_SPEC=k``,
k > 0; ``serving/specdec``): a tick drafts k tokens a slot with a cheap
self-draft, verifies them in one (k+1)-position dispatch and commits the
accepted prefix plus the correction, bitwise what the plain tick would
emit.  k = 0 runs the plain tick and builds no draft.

Every dispatch replays a CUDA graph (the counterpart of the reference's
closed jit cache): each program the engine dispatches — the step, each
prefill bucket, and with speculation the draft's step and prefill buckets
and the verify — has a ``fluid/program_graph.py`` ``ProgramGraph`` over the
scope's own weight and cache tensors, made ready (captured) in
``warmup()``.  A dispatch copies the feeds into static buffers, replays
and copies the fetches back; ``bucket_compiles`` counts graphs made ready
and stays flat after ``warmup()``.  On the CPU the same runners run each
dispatch eagerly over the same static buffers.

Entry points run on the card (``CUDAPlace(0)``) unless the caller passes
another place; with no place and no CUDA device the engine raises.

Not in this slice: a draft loaded from a registry serial
(``spec_draft_serial`` raises), the hot-swap machinery around
:meth:`DecodeEngine.swap_weights` (canary, rollback, cache scrub), the
tick monitor, the compile-cache manifest and trace spans.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fluid.program_graph import ProgramGraph
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
    ``spec``               speculation depth k (draft + verify ticks);
                           None reads ``PADDLE_SERVE_SPEC``; 0 = plain;
    ``spec_draft_layers``  self-draft depth; None reads
                           ``PADDLE_SERVE_SPEC_DRAFT_LAYERS`` (0 = full
                           depth);
    ``spec_draft_serial``  a registry serial to load the draft's weights
                           from: needs ``serving/registry.py``, not
                           ported yet (raises NotImplementedError).
    """
    max_queue_depth: int = 256
    default_timeout_ms: Optional[float] = None
    idle_wait_s: float = 0.05
    spec: Optional[int] = None
    spec_draft_layers: Optional[int] = None
    spec_draft_serial: Optional[str] = None


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
        if self.config.spec_draft_serial is not None:
            raise NotImplementedError(
                "spec_draft_serial needs serving/registry.py, which is not "
                "ported to paddle_tpu_torch yet (ROADMAP queue 1 item 10); "
                "use the self-draft (spec_draft_layers)")
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
        # one graph runner per (program, scope, fetches): the closed set
        self._runners: Dict[tuple, ProgramGraph] = {}
        self._ticks = 0
        # speculative decoding: DecodeConfig fields beat the env knobs;
        # k = 0 runs the plain tick and builds no draft
        self._spec = None
        spec_k = (self.config.spec if self.config.spec is not None
                  else int(_ec.get("PADDLE_SERVE_SPEC") or 0))
        if spec_k > 0:
            from .specdec import SpecDecoder

            draft_layers = (
                self.config.spec_draft_layers
                if self.config.spec_draft_layers is not None
                else int(_ec.get("PADDLE_SERVE_SPEC_DRAFT_LAYERS")))
            self._spec = SpecDecoder(
                self, spec_k, draft_layers,
                min_accept=float(_ec.get("PADDLE_SERVE_SPEC_MIN_ACCEPT")),
                window=int(_ec.get("PADDLE_SERVE_SPEC_WINDOW")))
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
        from ..fluid import fault as _fault

        while True:
            with self._cond:
                while not self._n_active and not self._stopped \
                        and not self._queue:
                    self._cond.wait(self.config.idle_wait_s)
                if self._stopped:
                    break
            with self._dispatch_lock:
                # the per-tick injected stall (PADDLE_FAULT_DECODE_STALL_MS)
                _fault.decode_stall()
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

    def _prompt_tokens(self, prompt):
        """The prompt padded to its bucket: ``([1, bucket] int64, bucket)``."""
        bucket = self.model.bucket_for(len(prompt))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(prompt)] = prompt
        return tokens, bucket

    def _run_prefill(self, prompt, slot, grant) -> bool:
        """One admitted request's bucketed prefill dispatch (after its
        pages were granted).  Skipped on a full prefix hit, where every
        page it would write is already resident; on a PARTIAL hit it runs,
        since rewriting a shared page with the same (bucket, prefix)
        content is idempotent.  Returns True when it dispatched."""
        if grant is not None and grant.full_hit:
            return False
        model = self.model
        tokens, bucket = self._prompt_tokens(prompt)
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
        if self._spec is not None:
            # the draft's cache is private: its prefill runs even when the
            # target's was a full-hit skip
            self._spec.prefill(slot, *self._prompt_tokens(req.prompt))
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

    def _step_dispatch(self, slots, count_tick=True):
        """ONE decode step over all slots; returns the [S] next tokens,
        the set of paged slots that stalled this tick, and the [S, V]
        logits.  ``count_tick=False`` leaves the engine tick alone (the
        spec tick's tail dispatch: one scheduling iteration counts once)."""
        feeds, stalled = self._tick_feeds(slots)
        nxt, logits = self._run(self.model.step_program, feeds,
                                [self.model.step_fetch,
                                 self.model.logits_fetch])
        if count_tick:
            self._ticks += 1
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

    def _stall_expire(self, i: int, req: _Request, t1: float) -> None:
        """Pool-dry stall: the row ran masked (trash write, active 0), its
        token is discarded, pos keeps, and it retries next tick.  An
        expired staller must still retire and return its pages, or mutual
        stalls could live-lock the pool."""
        if req.deadline is not None and t1 > req.deadline:
            self._retire(i, error=RequestTimeout(
                f"deadline expired after {len(req.out_tokens)} "
                f"generated tokens (pool-stalled)"))

    def _tick(self):
        if self._spec is not None and self._spec.run_tick():
            return  # a draft + verify tick ran
        nxt, stalled, _ = self._step_dispatch(self._slots)
        t1 = time.perf_counter()
        for i, req in enumerate(list(self._slots)):
            if req is None:
                continue
            if i in stalled:
                self._stall_expire(i, req, t1)
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
        if self._spec is not None:
            # the slot's next resident starts with a fresh acceptance rate
            self._spec.controller.retire_slot(slot)
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

    def swap_weights(self, weights: Dict[str, np.ndarray]) -> None:
        """Write the named weights into the engine's scope between ticks
        (the reference's ``swap_weights``).  Each is copied into the
        scope's tensor in place, so every graph runs on over it; the
        self-draft re-copies the weights it shares by name, and the page
        pool forgets its prefix index (resident pages hold the old
        weights' K/V).  An unknown name or a shape or dtype mismatch
        raises before anything is written."""
        from ..models.params import load_reference_params

        with self._dispatch_lock:
            load_reference_params(self._scope, weights, self._exe.place)
            if self._pool is not None:
                self._pool.flush_index()
            if self._spec is not None:
                self._spec.draft.sync(self._scope)

    # ------------------------------------------------------------------
    # dispatch plumbing + warmup
    # ------------------------------------------------------------------

    def _run(self, program, feed, fetch_list, scope=None):
        """One dispatch of ``program`` through its graph runner, against
        the engine's scope or ``scope`` (the spec draft's).  A runner is
        built at a program's first dispatch; ``bucket_compiles`` counts
        the runners made ready (on the card: captured), which ``warmup()``
        does for the whole set."""
        scope = scope if scope is not None else self._scope
        key = (program._cache_token, program._version, id(scope),
               tuple(fetch_list))
        runner = self._runners.get(key)
        if runner is None:
            runner = self._runners[key] = ProgramGraph(
                program, feed, fetch_list, scope, self._exe.device)
        was_ready = runner.ready
        outs = runner.run(feed)
        self.metrics.inc("dispatches")
        if not was_ready and runner.ready:
            self.metrics.inc("bucket_compiles")
        return outs

    def executables(self) -> int:
        """Graph runners resident in the engine: one step and one per
        prefill bucket, and with speculation one draft step, one per draft
        prefill bucket and the verify."""
        return len(self._runners)

    def graph_pool_bytes(self) -> int:
        """Device memory the caching allocator reserved for the engine's
        CUDA graph pools (0 on the CPU)."""
        return sum(r.graph.pool_bytes or 0 for r in self._runners.values())

    def _ready(self, dispatch) -> None:
        """Repeat a warmup dispatch until its program is one replay: once
        on the CPU, twice on the card (an eager run, then the capture and
        its first replay)."""
        for _ in range(2 if self._exe.device.type == "cuda" else 1):
            dispatch()
        self.metrics.inc("warmup_dispatches")

    def warmup(self) -> int:
        """Make every program of the closed set ready before traffic — each
        prefill bucket against the trash page (or slot 0 when dense), one
        all-idle decode step, and with speculation the draft's prefills and
        step and an all-idle verify — so traffic only replays graphs.  The
        writes land nowhere a stream reads.  Safe to call again; returns
        :meth:`executables`.

        The captures run on the caller's thread while the worker waits on
        its condition (no CUDA call) for the dispatch lock held here, and
        in ``thread_local`` capture mode (``StepGraph``)."""
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
                self._ready(lambda b=b, feeds=feeds: self._run(
                    model.prefill_program(b), feeds, []))
            self._ready(lambda: self._step_dispatch([None] * model.max_slots,
                                                    count_tick=False))
            if self._spec is not None:
                self._spec.warmup(self._ready)
        return self.executables()

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
        """Drain, stop the worker, and drop the graphs and their memory
        pools (the scope keeps the weights and caches)."""
        ok = self.drain(timeout_s=timeout_s)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)
        if not self._worker.is_alive():
            with self._dispatch_lock:
                for runner in self._runners.values():
                    runner.close()
                self._runners.clear()
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
