"""The port's speculative decoding (``serving/specdec``) against the JAX
package's, on the CPU, at ``decode_lm_config()`` size.

Weights are carried across with the engine's ``swap_weights`` (the draft
then copies them by name); inputs come from numpy seeds.  Tolerances: integer
results (tokens, acceptance counts, page ids, controller decisions)
exact; fp32 logits within ``LOGIT_TOL`` of the JAX package's (reduction
order in XLA's and PyTorch's CPU matmuls); within the port, verify logits
bitwise equal to the step's, and spec streams bitwise equal to the plain
engine's ``decode_static``.
"""

import time
import types
from concurrent.futures import wait

import numpy as np
import pytest

from paddle_tpu import fluid as ref_fluid
from paddle_tpu.fluid import layers as ref_layers
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu.serving import DecodeConfig as RefConfig
from paddle_tpu.serving import DecodeEngine as RefEngine
from paddle_tpu.serving import PagePool as RefPool
from paddle_tpu.serving import SpecController as RefController
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      RequestTimeout)
from paddle_tpu_torch.serving.kvpool import PagePool
from paddle_tpu_torch.serving.specdec import SpecController

SLOTS, MAX_LEN, BUCKETS, PS, K = 3, 24, [4, 8], 4, 2
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    fault.clear()
    yield
    fault.clear()


def _shape(paged, **kw):
    out = dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS,
               paged=paged)
    if paged:
        out["page_size"] = PS
    out.update(kw)
    return out


def _weights(ref_eng):
    return {v.name: np.asarray(ref_eng._scope.get(v.name))
            for v in ref_eng.model.startup.list_vars() if v.persistable}


def _port_engine(arrays, paged, config, **kw):
    model = port_tf.DecodeModel(port_tf.decode_lm_config(),
                                **_shape(paged, **kw))
    eng = DecodeEngine(model, config, place=fluid.CPUPlace())
    eng.swap_weights(arrays)
    return eng


@pytest.fixture(scope="module")
def engines():
    """{paged: (JAX spec engine, port spec engine)}, k = 2, draft depth 1,
    the port's over the JAX engine's weights."""
    out = {}
    for paged in (False, True):
        ref = RefEngine(ref_tf.DecodeModel(ref_tf.decode_lm_config(),
                                           **_shape(paged)),
                        RefConfig(spec=K, spec_draft_layers=1))
        port_framework.fresh_session()
        port = _port_engine(_weights(ref), paged,
                            DecodeConfig(spec=K, spec_draft_layers=1))
        port.warmup()
        out[paged] = (ref, port)
    yield out
    for ref, port in out.values():
        port.shutdown(timeout_s=30)
        ref.shutdown(timeout_s=30)


def _jobs(vocab, n=7, seed=21):
    """More requests than slots: prompts 1-8 tokens, 4-10 new tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(4, 11))) for _ in range(n)]


# ---------------------------------------------------------------------------
# the two ops, against the reference's
# ---------------------------------------------------------------------------

def _run_both(build, feeds, n_fetch):
    """Build one program with ``build(layers)`` in each package, run it on
    ``feeds`` on the CPU, return (reference fetches, port fetches)."""
    outs = []
    for fl, ly in ((ref_fluid, ref_layers), (fluid, layers)):
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup), fl.unique_name.guard():
            fetch = build(ly)
        exe = fl.Executor(fl.CPUPlace())
        got = exe.run(prog, feed={k: v.copy() for k, v in feeds.items()},
                      fetch_list=list(fetch)[:n_fetch])
        outs.append([np.asarray(x) for x in got])
    return outs


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_spec_accept_matches_reference(masked):
    rng = np.random.default_rng(5)
    s, k, v = 6, 3, 11
    logits = rng.standard_normal((s, k + 1, v)).astype(np.float32)
    argmax = logits.argmax(-1)
    draft = rng.integers(0, v, (s, k))
    for i in range(s):  # slot i agrees with the argmax on its first i % 4
        draft[i, :i % (k + 1)] = argmax[i, :i % (k + 1)]
    logits[5, 1, :] = logits[5, 1, 0]  # a tie: the lowest index wins
    feeds = {"sa_l": logits, "sa_d": draft.astype(np.int64),
             "sa_m": np.array([1, 0, 1, 1, 0, 1], np.float32)}

    def build(ly):
        lg = ly.data("sa_l", shape=[s, k + 1, v], dtype="float32",
                     append_batch_size=False)
        dr = ly.data("sa_d", shape=[s, k], dtype="int64",
                     append_batch_size=False)
        mask = ly.data("sa_m", shape=[s], dtype="float32",
                       append_batch_size=False) if masked else None
        return ly.spec_accept(lg, dr, mask=mask, end_id=1)

    want, got = _run_both(build, feeds, 2)
    for w, g in zip(want, got):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sorted(set(want[1].tolist())) == [0, 1, 2, 3]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_cache_scatter_matches_reference(paged):
    """Dense: a [3, 24, 16] slot cache, masked lanes at the trash row 3 ==
    R (the reference drops them), one lane at an in-range slot; paged: a
    [7 + 1, 4, 16] page pool, masked lanes at the trash page 7."""
    rng = np.random.default_rng(6)
    d = 16
    if paged:
        cache = rng.standard_normal((8, PS, d)).astype(np.float32)
        rows = np.array([2, 7, 5, 7, 0, 2], np.int64)
        offs = np.array([1, 0, 3, 2, 0, 2], np.int64)
    else:
        cache = rng.standard_normal((3, MAX_LEN, d)).astype(np.float32)
        rows = np.array([0, 3, 2, 3, 0, 1], np.int64)
        offs = np.array([5, 0, 23, 7, 6, 0], np.int64)
    new = rng.standard_normal((len(rows), d)).astype(np.float32)
    feeds = {"sc_c": cache, "sc_n": new, "sc_r": rows, "sc_o": offs}

    def build(ly):
        c = ly.data("sc_c", shape=list(cache.shape), dtype="float32",
                    append_batch_size=False)
        n = ly.data("sc_n", shape=[len(rows), d], dtype="float32",
                    append_batch_size=False)
        r = ly.data("sc_r", shape=[len(rows)], dtype="int64",
                    append_batch_size=False)
        o = ly.data("sc_o", shape=[len(rows)], dtype="int64",
                    append_batch_size=False)
        return [ly.kv_cache_scatter(c, n, r, o)]

    (want,), (got,) = _run_both(build, feeds, 1)
    np.testing.assert_array_equal(got, want)
    live = rows < cache.shape[0]
    assert not np.array_equal(got[rows[live], offs[live]],
                              cache[rows[live], offs[live]])
    if not paged:  # the masked lanes wrote nowhere
        untouched = np.ones(cache.shape[:2], bool)
        untouched[rows[live], offs[live]] = False
        np.testing.assert_array_equal(got[untouched], cache[untouched])


def test_kv_cache_scatter_with_no_lane_in_range_writes_nothing():
    cache = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)

    def build(ly):
        c = ly.data("sc_c", shape=[2, 4, 3], dtype="float32",
                    append_batch_size=False)
        n = ly.data("sc_n", shape=[2, 3], dtype="float32",
                    append_batch_size=False)
        r = ly.data("sc_r", shape=[2], dtype="int64",
                    append_batch_size=False)
        return [ly.kv_cache_scatter(c, n, r, r)]

    (want,), (got,) = _run_both(build, {
        "sc_c": cache, "sc_n": np.ones((2, 3), np.float32),
        "sc_r": np.array([2, 2], np.int64)}, 1)
    np.testing.assert_array_equal(want, cache)
    np.testing.assert_array_equal(got, cache)


# ---------------------------------------------------------------------------
# the verify program
# ---------------------------------------------------------------------------

def _ops(prog):
    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return v.item() if isinstance(v, np.generic) else v

    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


def _feed_vars(prog):
    return {v.name: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for v in prog.global_block().vars.values()
            if v.name.startswith("sp_")}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_program_matches_reference(paged):
    ref_m = ref_tf.DecodeModel(ref_tf.decode_lm_config(), **_shape(paged))
    port_m = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(paged))
    ref_p, *ref_f = ref_m.spec_program(K)
    port_p, *port_f = port_m.spec_program(K)
    assert port_f == ref_f
    assert _ops(port_p) == _ops(ref_p)
    assert _feed_vars(port_p) == _feed_vars(ref_p)
    assert port_m.spec_program(K)[0] is port_p  # built once
    assert port_m.weight_names() == ref_m.weight_names()
    with pytest.raises(ValueError):
        port_m.spec_program(0)


def _verify_feeds(model, pool, bases, tok0, drafted):
    """Verify feeds for slots 0..len(bases)-1 at positions bases[i]..+K."""
    s, w = model.max_slots, K + 1
    n = len(bases)
    act = np.zeros((s,), np.float32)
    act[:n] = 1.0
    drafts = np.zeros((s, K), np.int64)
    drafts[:n] = drafted
    feeds = {model.SP_DRAFT: drafts, model.SP_ACTIVE: act}
    trash = pool.trash_page if pool is not None else model.max_slots
    for j in range(w):
        tok = np.zeros((s, 1), np.int64)
        pos = np.zeros((s,), np.int64)
        wrow = np.full((s,), trash, np.int64)
        woff = np.zeros((s,), np.int64)
        for i in range(n):
            tok[i, 0] = tok0[i] if j == 0 else drafted[i, j - 1]
            pos[i] = bases[i] + j
            if pool is not None:
                assert pool.ensure(i, int(pos[i]))
                wrow[i], woff[i] = pool.write_loc(i, int(pos[i]))
            else:
                wrow[i], woff[i] = i, pos[i]
        feeds[model.SP_TOK.format(j)] = tok
        feeds[model.SP_PE.format(j)] = model.posenc_rows(pos).astype(
            np.float32)
        feeds[model.SP_BIAS_J.format(j)] = model.validity_bias(pos)
        feeds[model.SP_WROW.format(j)] = wrow
        feeds[model.SP_WOFF.format(j)] = woff
    if pool is not None:  # after the growth above
        feeds[model.SP_PTABLE] = pool.table()
    return feeds


PROMPTS = [[5, 9, 11], [7, 3, 3, 8, 2, 60, 4], [40, 41, 42, 43, 44]]


def _verify_then_steps(eng, drafted):
    """Prefill PROMPTS, run one verify (all K + 1 positions' logits
    fetched), then K + 1 plain steps fed the same tokens.  Returns
    (verify logits [S, K+1, V], step logits [K+1, S, V], verify tokens
    and acceptance)."""
    model, pool = eng.model, eng._pool
    prog, tok_f, nacc_f, _ = model.spec_program(K)
    concat = next(op for op in prog.global_block().ops
                  if op.type == "spec_accept").inputs["Logits"][0]
    with eng._dispatch_lock:
        try:
            bases, tok0 = [], []
            for i, prompt in enumerate(PROMPTS):
                bucket = model.bucket_for(len(prompt))
                tokens = np.zeros((1, bucket), np.int64)
                tokens[0, :len(prompt)] = prompt
                feeds = {model.PF_TOKENS: tokens}
                if pool is not None:
                    assert pool.admit(i, prompt, bucket) is not None
                    feeds[model.PF_PAGES] = pool.prefill_pages(i, bucket)
                else:
                    feeds[model.PF_SLOT] = np.asarray([i], np.int64)
                eng._run(model.prefill_program(bucket), feeds, [])
                bases.append(len(prompt) - 1)
                tok0.append(prompt[-1])
            vl, toks, nacc = eng._run(
                prog, _verify_feeds(model, pool, bases, tok0, drafted),
                [concat, tok_f, nacc_f])
            steps = []
            slots = [types.SimpleNamespace(prompt=list(p), out_tokens=[],
                                           pos=b)
                     for p, b in zip(PROMPTS, bases)]
            for j in range(K + 1):
                _, stalled, logits = eng._step_dispatch(slots,
                                                        count_tick=False)
                assert not stalled
                steps.append(np.asarray(logits))
                for i, r in enumerate(slots):
                    if j < K:
                        r.out_tokens.append(int(drafted[i, j]))
                    r.pos += 1
        finally:
            if pool is not None:
                for i in range(len(PROMPTS)):
                    pool.release(i)
    return np.asarray(vl), np.stack(steps), toks, nacc


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_logits_bitwise_step_and_near_jax(engines, paged):
    """Verify logits at every position j are bitwise the port's own step
    logits after the same tokens, and within LOGIT_TOL of the JAX
    package's verify; tokens and acceptance agree with the JAX package's
    where its top-1 margins are clear."""
    ref, port = engines[paged]
    drafted = np.random.default_rng(8).integers(
        2, port.model.vocab_size, (len(PROMPTS), K))
    got, steps, toks, nacc = _verify_then_steps(port, drafted)
    want, _, ref_toks, ref_nacc = _verify_then_steps(ref, drafted)
    n = len(PROMPTS)
    for j in range(K + 1):
        np.testing.assert_array_equal(got[:n, j], steps[j][:n])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL
    assert clear[:n].mean() > 0.9
    np.testing.assert_array_equal(toks[clear], ref_toks[clear])
    rows = clear.all(axis=1)
    np.testing.assert_array_equal(nacc[rows], ref_nacc[rows])


# ---------------------------------------------------------------------------
# host-side units against the reference's, one scripted sequence
# ---------------------------------------------------------------------------

def _controller_script(ctl):
    seen = [ctl.armed, ctl.rate()]
    for sample in ({0: (2, 2), 1: (1, 2)}, {0: (0, 2)},
                   {0: (0, 2), 1: (0, 2)}, {2: (1, 2)}):
        ctl.observe(sample)
        seen += [ctl.armed, ctl.rate(), ctl.slot_rate(0), ctl.fallbacks]
    for _ in range(4):
        ctl.note_plain_tick()
        seen += [ctl.armed, ctl.rate()]
    ctl.observe({2: (1, 2)})
    ctl.retire_slot(2)
    seen += [ctl.slot_rate(2), ctl.slot_rate(0), ctl.rate()]
    return seen


def _rewind_script(pool):
    seen = [pool.admit(0, [2, 3, 4], 4).pages]
    seen += [[pool.ensure(0, p) for p in (4, 8, 12)], pool.pages_free]
    seen += [pool.rewind(0, 5), pool.pages_free, pool.slot_pages(0)]
    seen += [pool.rewind(0, 5), pool.ensure(0, 8), pool.rewind(0, 7),
             pool.rewind(0, 8), pool.rewind(5, 0), pool.pages_leaked]
    seen += [pool.release(0), pool.pages_free, pool.pages_leaked]
    return seen


def test_controller_and_rewind_match_reference():
    want = _controller_script(RefController(min_accept=0.5, window=3))
    got = _controller_script(SpecController(min_accept=0.5, window=3))
    assert got == want
    assert False in want and want[-1] is not None
    kw = dict(num_pages=6, page_size=4, pages_per_slot=6, max_slots=1,
              prefix_share=False)
    want = _rewind_script(RefPool(**kw))
    got = _rewind_script(PagePool(**kw))
    assert got == want
    assert got[3] == 2 and got[-3] == 2


def test_spec_counters_and_gauge():
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    ctl = SpecController(min_accept=0.9, window=2, metrics=m)
    ctl.observe({0: (1, 2)})
    ctl.observe({0: (0, 2)})
    snap = m.snapshot()
    assert snap["spec_fallbacks"] == 1 and snap["spec_accept_rate"] == 0.25
    for name in ("spec_ticks", "spec_draft_tokens", "spec_accepted_tokens",
                 "bucket_compiles", "dispatches"):
        assert snap[name] == 0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_streams_bitwise_decode_static(engines, paged):
    """More requests than slots through the spec engine: churn, growth
    and rewind; every stream bitwise equal to the plain engine's
    ``decode_static`` of it alone, no page leaked, the graph set closed."""
    _, eng = engines[paged]
    pool = eng._pool
    free0 = pool.pages_free if pool is not None else None
    exes0 = eng.executables()
    compiles0 = eng.metrics.counter("bucket_compiles")
    ticks0 = eng.metrics.counter("spec_ticks")
    jobs = _jobs(eng.model.vocab_size)
    futs = [eng.submit(p, n) for p, n in jobs]
    outs = [f.result(timeout=120) for f in futs]
    assert eng.wait_idle(timeout_s=30)
    assert eng.metrics.counter("spec_ticks") > ticks0
    assert outs == [eng.decode_static([j])[0][0] for j in jobs]
    assert eng.executables() == exes0
    assert eng.metrics.counter("bucket_compiles") == compiles0
    if pool is not None:
        assert pool.pages_free == free0 and pool.pages_leaked == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_tail_beside_speculation_stays_bitwise(paged, monkeypatch):
    """An 8-token prompt runs into max_len while two 1-token prompts,
    admitted with it, still speculate: the ticks that carry a tail step
    leave the speculating slots' caches as sequential decode has them
    (in a dense cache the step writes every lane), so every stream is
    bitwise its ``decode_static``.  With the controller never falling
    back, the seed-7 weights and these prompts put a tail step beside
    speculation in each round."""
    monkeypatch.setenv("PADDLE_SERVE_SPEC_MIN_ACCEPT", "0")
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(paged))
    with DecodeEngine(model, DecodeConfig(spec=K, spec_draft_layers=1),
                      place=fluid.CPUPlace()) as eng:
        eng.warmup()
        pool = eng._pool
        free0 = pool.pages_free if pool is not None else None
        for seed in (3, 4, 6):
            rng = np.random.default_rng(seed)
            jobs = [(rng.integers(2, model.vocab_size, 8).tolist(),
                     MAX_LEN - 8)]
            jobs += [(rng.integers(2, model.vocab_size, 1).tolist(),
                      MAX_LEN - 1) for _ in range(2)]
            tail0 = eng._spec.tail_ticks
            with eng._dispatch_lock:  # all three admitted in one pass
                futs = [eng.submit(p, n) for p, n in jobs]
            outs = [f.result(timeout=120) for f in futs]
            assert eng.wait_idle(timeout_s=30)
            assert eng._spec.tail_ticks > tail0, seed
            assert [len(o) for o in outs] == [n for _, n in jobs]
            assert outs == [eng.decode_static([j])[0][0] for j in jobs], seed
        if pool is not None:
            assert pool.pages_free == free0 and pool.pages_leaked == 0


def test_swap_weights_resyncs_the_draft():
    """New weights through ``swap_weights``: the full-depth self-draft
    copies them too (it still accepts every token), the stream is
    bitwise ``decode_static`` over the new weights, and the pool forgets
    the prefix pages the old weights wrote.  A bad name writes nothing."""
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(
        True, max_slots=2, max_len=16, prefill_buckets=[8]))
    rng = np.random.default_rng(9)
    with DecodeEngine(model, DecodeConfig(spec=K, spec_draft_layers=0),
                      place=fluid.CPUPlace()) as eng:
        eng.warmup()
        job = ([3, 5, 7, 9, 11, 13], 9)
        old = eng.generate(*job)
        pool = eng._pool
        # slot 1 holds the prompt's first page, written by the old weights
        assert pool.admit(1, job[0], 8).pages
        new = {n: (eng.scope.get(n).numpy()
                   + rng.standard_normal(eng.scope.get(n).shape)
                   .astype(np.float32))
               for n in model.weight_names()}
        with pytest.raises(KeyError):
            eng.swap_weights({"no_such": new["dlm_emb"], **new})
        assert eng.generate(*job) == old
        eng.swap_weights(new)
        assert pool.admit(0, job[0], 8).hits == 0
        pool.release(0)
        pool.release(1)
        drafted0 = eng.metrics.counter("spec_draft_tokens")
        accepted0 = eng.metrics.counter("spec_accepted_tokens")
        got = eng.generate(*job)
        assert got == eng.decode_static([job])[0][0]
        assert got != old
        draft = eng._spec.draft.scope
        assert all(np.array_equal(draft.get(n).numpy(), new[n])
                   for n in eng._spec.draft.model.weight_names())
    drafted = eng.metrics.counter("spec_draft_tokens") - drafted0
    assert drafted > 0
    assert eng.metrics.counter("spec_accepted_tokens") - accepted0 == drafted


def _ref_margins(ref, prompt, stream):
    """The JAX engine's top-1 margin at each position of ``stream``, one
    slot teacher-forced along it."""
    model = ref.model
    slots = [None] * model.max_slots
    margins = []
    with ref._dispatch_lock:
        try:
            bucket = model.bucket_for(len(prompt))
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :len(prompt)] = prompt
            feeds = {model.PF_TOKENS: tokens}
            if ref._pool is not None:
                assert ref._pool.admit(0, prompt, bucket) is not None
                feeds[model.PF_PAGES] = ref._pool.prefill_pages(0, bucket)
            else:
                feeds[model.PF_SLOT] = np.asarray([0], np.int64)
            ref._run(model.prefill_program(bucket), feeds, [])
            slots[0] = types.SimpleNamespace(prompt=list(prompt),
                                             out_tokens=[],
                                             pos=len(prompt) - 1)
            for tok in stream:
                _, _, logits = ref._step_dispatch(slots, count_tick=False)
                top2 = np.sort(np.asarray(logits)[0])[-2:]
                margins.append(top2[1] - top2[0])
                slots[0].out_tokens.append(tok)
                slots[0].pos += 1
        finally:
            if ref._pool is not None:
                ref._pool.release(0)
    return margins


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_streams_match_jax_where_margins_are_clear(engines, paged):
    ref, port = engines[paged]
    jobs = _jobs(port.model.vocab_size, n=5, seed=31)
    want = [f.result(timeout=120) for f in
            [ref.submit(p, n) for p, n in jobs]]
    got = [f.result(timeout=120) for f in
           [port.submit(p, n) for p, n in jobs]]
    assert ref.metrics.snapshot()["spec_ticks"] > 0
    compared = 0
    for (prompt, _), w, g in zip(jobs, want, got):
        for t, margin in enumerate(_ref_margins(ref, prompt, w)):
            if margin <= LOGIT_TOL:
                break
            assert g[t] == w[t], (prompt, t)
            compared += 1
    assert compared >= sum(len(w) for w in want) // 2


def test_spec_pages_return_on_mid_speculation_deadline(engines):
    """A speculating slot expires at its first commit (each draft step
    slowed by 60 ms against a 150 ms deadline): its pages, the verify's
    speculatively grown ones included, come back through the release
    path, and the other stream stays bitwise."""
    _, eng = engines[True]
    pool = eng._pool
    free0 = pool.pages_free
    jobs = _jobs(eng.model.vocab_size, n=2, seed=33)
    long_job = (jobs[0][0], MAX_LEN - len(jobs[0][0]))
    assert len(eng.decode_static([long_job])[0][0]) == long_job[1]
    survivor = eng.decode_static([jobs[1]])[0][0]
    expired0 = eng.metrics.counter("expired")
    spec = eng._spec
    real = spec._draft_step

    def slow(*a):
        time.sleep(0.06)
        return real(*a)

    spec._draft_step = slow
    try:
        with eng._dispatch_lock:  # both admitted in one pass
            fa = eng.submit(*long_job, timeout_ms=150.0)
            fb = eng.submit(*jobs[1])
        with pytest.raises(RequestTimeout, match="generated tokens"):
            fa.result(timeout=120)
        assert fb.result(timeout=120) == survivor
    finally:
        del spec._draft_step
    assert eng.metrics.counter("expired") == expired0 + 1
    assert eng.wait_idle(timeout_s=30)
    assert pool.pages_free == free0 and pool.pages_leaked == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_full_depth_draft_accepts_everything(paged):
    """draft_layers=0: the draft is the target, every drafted token is
    accepted and a spec tick commits k + 1 tokens."""
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(
        paged, max_slots=2, max_len=16, prefill_buckets=[4]))
    with DecodeEngine(model, DecodeConfig(spec=K, spec_draft_layers=0),
                      place=fluid.CPUPlace()) as eng:
        assert eng._spec.draft.depth == model.cfg.n_layer
        eng.warmup()
        out = eng.generate([3, 5, 7], 9)
        snap = eng.metrics.snapshot()
        assert out == eng.decode_static([([3, 5, 7], 9)])[0][0]
    assert snap["spec_draft_tokens"] > 0
    assert snap["spec_accepted_tokens"] == snap["spec_draft_tokens"]
    assert snap["spec_accept_rate"] == 1.0
    assert snap["tokens_generated"] > snap["decode_ticks"]


def test_poison_drill_trips_fallback_and_stays_bitwise(monkeypatch):
    """PADDLE_FAULT_SPEC_DRAFT_POISON from tick 0 with a window of 3:
    acceptance collapses, the controller falls back and re-arms, and
    every stream is still bitwise its ``decode_static``."""
    monkeypatch.setenv("PADDLE_SERVE_SPEC_WINDOW", "3")
    monkeypatch.setenv("PADDLE_FAULT_SPEC_DRAFT_POISON", "0")
    fault.install(fault.FaultPlan.from_env())
    assert fault.spec_draft_poison() == 0
    model = port_tf.DecodeModel(port_tf.decode_lm_config(),
                                **_shape(True, max_len=32))
    jobs = [(p, 20) for p, _ in _jobs(model.vocab_size, n=4, seed=41)]
    with DecodeEngine(model, DecodeConfig(spec=K), place=fluid.CPUPlace()
                      ) as eng:
        eng.warmup()
        outs = [f.result(timeout=120)
                for f in [eng.submit(p, n) for p, n in jobs]]
        assert eng.wait_idle(timeout_s=30)
        snap = eng.metrics.snapshot()
        assert outs == [eng.decode_static([j])[0][0] for j in jobs]
        assert eng._pool.pages_leaked == 0
    assert snap["spec_fallbacks"] >= 1
    assert snap["spec_accepted_tokens"] < snap["spec_draft_tokens"] // 4
    # a fallback's cooldown ran plain ticks, then speculation re-armed
    assert snap["decode_ticks"] > snap["spec_ticks"] > 3


def test_spec_zero_builds_no_draft(engines, monkeypatch):
    monkeypatch.delenv("PADDLE_SERVE_SPEC", raising=False)
    _, spec_eng = engines[False]
    job = _jobs(spec_eng.model.vocab_size, n=1, seed=44)[0]
    arrays = {n: spec_eng.scope.get(n).numpy()
              for n in spec_eng.model.weight_names()}
    for config in (None, DecodeConfig(spec=0)):
        eng = _port_engine(arrays, False, config)
        try:
            assert eng._spec is None
            eng.warmup()
            assert eng.executables() == 1 + len(BUCKETS)
            assert eng.generate(*job) == spec_eng.generate(*job)
            assert eng.metrics.counter("spec_ticks") == 0
        finally:
            eng.shutdown(timeout_s=30)


def test_spec_draft_serial_raises():
    import threading

    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(True))
    threads = threading.active_count()
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        DecodeEngine(model, DecodeConfig(spec=K, spec_draft_serial="/x"),
                     place=fluid.CPUPlace())
    assert threading.active_count() == threads


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv("PADDLE_FAULT_SPEC_DRAFT_POISON", raising=False)
    assert fault.FaultPlan.from_env() is None
    assert fault.spec_draft_poison() is None
    fault.install(fault.FaultPlan(spec_draft_poison=7))
    assert fault.active().spec_draft_poison == 7
    fault.clear()
    assert fault.spec_draft_poison() is None
    plan = fault.FaultPlan.from_env({"PADDLE_FAULT_SPEC_DRAFT_POISON": "5"})
    assert plan.spec_draft_poison == 5


def test_churn_with_spec_on_a_small_pool_leaks_nothing():
    """The plain engine's churn mix (``test_torch_decode.py``) under
    speculation: 5 pages for 3 slots, so admissions re-queue and the
    verify's speculative growth finds the pool dry (acceptance capped
    below the dry page, or the whole slot stalled); the 8-token jobs
    retire after their one token, so some slot always progresses.  Every
    request completes bitwise, every page comes back."""
    model = port_tf.DecodeModel(port_tf.decode_lm_config(),
                                **_shape(True, max_len=16, num_pages=5))
    rng = np.random.default_rng(1)
    jobs = [(rng.integers(2, model.vocab_size, n).tolist(), m)
            for n, m in [(8, 1), (8, 1), (8, 1), (4, 4), (4, 4), (4, 4),
                         (8, 1), (4, 4)]]
    with DecodeEngine(model, DecodeConfig(spec=K), place=fluid.CPUPlace()
                      ) as eng:
        eng.warmup()
        with eng._dispatch_lock:  # queue everything before any admission
            futs = [eng.submit(p, n) for p, n in jobs]
        done, _ = wait(futs, timeout=120)
        assert len(done) == len(futs)
        outs = [f.result() for f in futs]
        assert eng.wait_idle(30)
        snap = eng.metrics.snapshot()
        assert snap["page_requeues"] > 0 and snap["spec_ticks"] > 0
        assert eng._pool.pages_free == 5 and eng._pool.pages_leaked == 0
        for (p, n), got in zip(jobs, outs):
            assert eng.decode_static([(p, n)])[0][0] == got
