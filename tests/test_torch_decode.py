"""The port's paged decode engine against the JAX package's, on the CPU.

Weights are carried across with ``load_reference_params`` (the two
packages' startup initializers draw from different generators), then:

 - prefill plus 8 teacher-forced decode ticks give step logits within
   1e-4 of the JAX engine's (float32 on both sides; the gap is reduction
   order in XLA's and PyTorch's CPU matmuls over 6 ops per layer), and
   the selected tokens agree wherever the JAX top-1 margin exceeds that
   tolerance;
 - within the port, continuous batching equals ``decode_static`` of each
   request alone BITWISE, paged equals dense BITWISE (one plain PyTorch
   path on both), and churn with requeues and stalls on a small pool
   leaks no page;
 - the host-side page pool makes the same decisions as the JAX
   package's, call for call.
"""

import types
from concurrent.futures import wait

import numpy as np
import pytest

from paddle_tpu.models import transformer as ref_tf
from paddle_tpu.serving import DecodeEngine as RefEngine
from paddle_tpu.serving import PagePool as RefPool
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import paged_attention as port_pa
from paddle_tpu_torch.serving import DecodeEngine, RequestTimeout
from paddle_tpu_torch.serving.kvpool import PagePool

SLOTS, MAX_LEN, BUCKETS, PS = 3, 24, [4, 8], 4
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _shape(paged, **kw):
    out = dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS,
               paged=paged)
    if paged:
        out["page_size"] = PS
    out.update(kw)
    return out


def _weights(ref_eng, with_caches=True):
    return {v.name: np.asarray(ref_eng._scope.get(v.name))
            for v in ref_eng.model.startup.list_vars()
            if v.persistable and (with_caches or "_cache_" not in v.name)}


def _port_engine(arrays, paged=True, **kw):
    model = port_tf.DecodeModel(port_tf.decode_lm_config(),
                                **_shape(paged, **kw))
    eng = DecodeEngine(model, place=fluid.CPUPlace())
    port_tf.load_reference_params(eng.scope, arrays, fluid.CPUPlace())
    return eng


@pytest.fixture(scope="module")
def engines():
    """The JAX paged engine and the port's paged and dense engines, all
    over the JAX engine's weights."""
    ref = RefEngine(ref_tf.DecodeModel(ref_tf.decode_lm_config(),
                                       **_shape(True)))
    port_framework.fresh_session()
    arrays = _weights(ref)
    paged = _port_engine(arrays)
    dense = _port_engine(_weights(ref, with_caches=False), paged=False)
    yield ref, paged, dense
    for eng in (dense, paged, ref):
        eng.shutdown(timeout_s=30)


def _jobs(vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, vocab, 4).tolist()
    jobs = [(prefix + rng.integers(2, vocab, 1).tolist(), 6),
            (prefix + rng.integers(2, vocab, 3).tolist(), 5)]
    for _ in range(n - 2):
        jobs.append((rng.integers(2, vocab, int(rng.integers(1, 9)))
                     .tolist(), int(rng.integers(2, 9))))
    return jobs


def _drive(eng, prompts, ticks, forced=None):
    """Admit ``prompts`` into slots 0.., prefill each, then run ``ticks``
    decode steps, feeding back ``forced[t]`` (teacher forcing) or the
    engine's own tokens.  Returns the [ticks, S, V] logits and [ticks, S]
    tokens; pages go back at the end.  Uses only surface both engines
    share, under the engine's dispatch lock."""
    model = eng.model
    slots = [None] * model.max_slots
    logits_all, toks_all = [], []
    with eng._dispatch_lock:
        try:
            for i, prompt in enumerate(prompts):
                bucket = model.bucket_for(len(prompt))
                tokens = np.zeros((1, bucket), np.int64)
                tokens[0, :len(prompt)] = prompt
                feeds = {model.PF_TOKENS: tokens}
                if eng._pool is not None:
                    assert eng._pool.admit(i, prompt, bucket) is not None
                    feeds[model.PF_PAGES] = eng._pool.prefill_pages(i,
                                                                    bucket)
                else:
                    feeds[model.PF_SLOT] = np.asarray([i], np.int64)
                eng._run(model.prefill_program(bucket), feeds, [])
                slots[i] = types.SimpleNamespace(
                    prompt=list(prompt), out_tokens=[], pos=len(prompt) - 1)
            for t in range(ticks):
                nxt, stalled, logits = eng._step_dispatch(slots)
                assert not stalled
                logits_all.append(np.asarray(logits))
                toks_all.append(np.asarray(nxt))
                for i, r in enumerate(slots):
                    if r is not None:
                        r.out_tokens.append(int(nxt[i] if forced is None
                                                else forced[t][i]))
                        r.pos += 1
        finally:
            if eng._pool is not None:
                for i in range(len(prompts)):
                    eng._pool.release(i)
    return np.stack(logits_all), np.stack(toks_all)


PROMPTS = [[5, 9, 11], [7, 3, 3, 8, 2, 60, 4], [40, 41, 42, 43, 44]]


def test_step_logits_match_jax(engines):
    ref, paged, _ = engines
    want, want_toks = _drive(ref, PROMPTS, 8)
    got, got_toks = _drive(paged, PROMPTS, 8, forced=want_toks)
    assert got.shape == want.shape == (8, SLOTS, ref.model.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_toks[clear], want_toks[clear])


def test_paged_equals_dense_bitwise(engines):
    _, paged, dense = engines
    lp, tp = _drive(paged, PROMPTS, 8)
    ld, td = _drive(dense, PROMPTS, 8)
    np.testing.assert_array_equal(lp, ld)
    np.testing.assert_array_equal(tp, td)


def test_continuous_equals_static_bitwise(engines):
    _, paged, _ = engines
    jobs = _jobs(paged.model.vocab_size)
    free0 = paged._pool.pages_free
    hits0 = paged.metrics.counter("prefix_hits")
    futs = [paged.submit(p, n) for p, n in jobs]
    outs = [f.result(timeout=60) for f in futs]
    assert paged.wait_idle(30)
    assert paged.metrics.counter("prefix_hits") > hits0
    assert paged._pool.pages_free == free0
    for (p, n), got in zip(jobs, outs):
        assert 1 <= len(got) <= n
        assert paged.decode_static([(p, n)])[0][0] == got
    assert paged._pool.pages_free == free0


def test_engine_streams_match_jax_where_margins_are_clear(engines):
    """Whole greedy streams of the two engines: equal up to the first
    position whose JAX top-1 margin is within the logit tolerance."""
    ref, paged, _ = engines
    want_logits, want = _drive(ref, PROMPTS, 6)
    _, got = _drive(paged, PROMPTS, 6)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    for s in range(SLOTS):
        for t in range(6):
            if top2[t, s, 1] - top2[t, s, 0] <= LOGIT_TOL:
                break
            assert got[t, s] == want[t, s], (s, t)


def test_kernel_not_launched_on_cpu(engines):
    _, paged, _ = engines
    before = port_pa.launches
    paged.generate([3, 4, 5], 3)
    assert port_pa.launches == before


def test_churn_on_a_small_pool_leaks_nothing():
    """5 pages for 3 slots: 8-token prompts take 2 pages at admission, so
    the third admission re-queues; 4-token prompts grow a second page
    while decoding and may stall on the dry pool.  No mix can stall every
    resident (the 8-token jobs never grow), every request completes
    bitwise equal to its static decode, and every page comes back."""
    model = port_tf.DecodeModel(port_tf.decode_lm_config(),
                                **_shape(True, max_len=16, num_pages=5))
    rng = np.random.default_rng(1)
    jobs = [(rng.integers(2, model.vocab_size, n).tolist(), m)
            for n, m in [(8, 1), (8, 1), (8, 1), (4, 4), (4, 4), (4, 4),
                         (8, 1), (4, 4)]]
    with DecodeEngine(model, place=fluid.CPUPlace()) as eng:
        eng.warmup()
        with eng._dispatch_lock:  # queue everything before any admission
            futs = [eng.submit(p, n) for p, n in jobs]
        done, _ = wait(futs, timeout=60)
        assert len(done) == len(futs)
        outs = [f.result() for f in futs]
        assert eng.wait_idle(30)
        snap = eng.metrics.snapshot()
        assert snap["page_requeues"] > 0
        assert snap["completed"] == len(jobs)
        assert eng._pool.pages_free == 5 and snap["kvpool_pages_live"] == 0
        for (p, n), got in zip(jobs, outs):
            assert eng.decode_static([(p, n)])[0][0] == got
        assert eng._pool.pages_free == 5


def test_deadline_expiry_returns_pages():
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **_shape(True))
    with DecodeEngine(model, place=fluid.CPUPlace()) as eng:
        free0 = eng._pool.pages_free
        fut = eng.submit([3, 4, 5, 6, 7], 18, timeout_ms=1e-3)
        with pytest.raises(RequestTimeout):
            fut.result(timeout=30)
        assert eng.wait_idle(30)
        assert eng._pool.pages_free == free0
        assert eng.metrics.counter("expired") == 1


@pytest.mark.parametrize("prompt,max_new", [
    ([], 4), ([3, 999], 4), ([3, 4], 0), (list(range(2, 11)), 4),
    ([3] * 8, 17)], ids=["empty", "vocab", "budget", "bucket", "capacity"])
def test_submit_rejects_bad_requests(engines, prompt, max_new):
    _, paged, _ = engines
    with pytest.raises(ValueError):
        paged.submit(prompt, max_new)


def test_load_reference_params_checks(engines):
    _, paged, _ = engines
    w = np.asarray(paged.scope.get("dlm_emb").numpy())
    with pytest.raises(KeyError):
        port_tf.load_reference_params(paged.scope, {"no_such": w},
                                      fluid.CPUPlace())
    with pytest.raises(ValueError):
        port_tf.load_reference_params(paged.scope, {"dlm_emb": w[:-1]},
                                      fluid.CPUPlace())
    with pytest.raises(TypeError):
        port_tf.load_reference_params(
            paged.scope, {"dlm_emb": w.astype(np.float64)}, fluid.CPUPlace())
    np.testing.assert_array_equal(paged.scope.get("dlm_emb").numpy(), w)


def _pool_script(pool):
    """A fixed sequence of pool calls; returns every observable result."""
    seen = []
    a = [2, 3, 4, 5, 6, 7, 8, 9, 10]
    seen.append(pool.admit(0, a, 12))
    seen.append(pool.admit(1, a[:5], 12))           # shares page 0
    seen.append(pool.admit(2, a + [11], 12))        # shares pages 0-1
    seen.append([pool.ensure(0, p) for p in (8, 11, 12, 16)])
    seen.append(pool.write_loc(0, 12))
    seen.append(pool.prefill_pages(2, 12))
    seen.append(pool.table())
    seen.append(pool.release(0))
    seen.append(pool.admit(0, [9] * 13, 16))        # may not fit
    seen.append(pool.release(2))
    seen.append(pool.table())
    seen.append((pool.pages_free, pool.pages_live))
    seen.append(pool.release(1))
    seen.append((pool.pages_free, pool.pages_live))
    return seen


def test_page_pool_decisions_match_jax():
    def norm(x):
        if hasattr(x, "pages"):
            return (x.slot, list(x.pages), x.hits, x.full_hit)
        return x.tolist() if isinstance(x, np.ndarray) else x

    kw = dict(num_pages=7, page_size=4, pages_per_slot=5, max_slots=3)
    want = [norm(x) for x in _pool_script(RefPool(**kw))]
    got = [norm(x) for x in _pool_script(PagePool(**kw))]
    assert got == want
    assert got[1][2] == 1 and got[2][2] == 2        # prefix hits happened


def test_metrics_snapshot_percentiles():
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics(latency_window=4)
    for s in (0.001, 0.002, 0.003, 0.004, 0.005):
        m.observe_ttft(s)
    m.inc("tokens_generated", 3)
    snap = m.snapshot()
    assert snap["tokens_generated"] == 3 and snap["ttft_samples"] == 4
    assert snap["ttft_p50_ms"] == pytest.approx(4.0)  # ring kept 2..5 ms
    assert snap["intertoken_p50_ms"] is None
