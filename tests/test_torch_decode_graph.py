"""The decode engine's graph runner (``fluid/program_graph.py``
``ProgramGraph``) run eagerly on the CPU, where it runs each dispatch over
the same static buffers the card captures:

 - its fetches, and the caches it updates, are bitwise those of
   ``Executor.run`` on the same program, feeds and starting state;
 - the runners of one scope — step, prefill buckets, verify — hold the
   scope's own tensors (the same objects), so no dispatch copies a weight
   or a cache, and the draft's runners hold the draft scope's;
 - ``bucket_compiles`` and ``executables()`` stay flat after ``warmup()``
   under traffic while ``dispatches`` grows;
 - a program that would rebind a persistable, or a scope tensor replaced
   under a runner, raises.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.executor import Scope
from paddle_tpu_torch.fluid.program_graph import ProgramGraph
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

SHAPE = dict(max_slots=3, max_len=24, prefill_buckets=[4, 8], paged=True,
             page_size=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _two_scopes(model):
    """Two scopes holding the same started state: random weights (a seed)
    and zero caches."""
    exe = fluid.Executor(fluid.CPUPlace())
    a, b = Scope(), Scope()
    exe.run(model.startup, scope=a)
    exe.run(model.startup, scope=b)
    gen = torch.Generator().manual_seed(3)
    for v in model.startup.list_vars():
        if v.persistable:
            t = a.get(v.name)
            if "_cache_" not in v.name:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
            b.get(v.name).copy_(t)
    return exe, a, b


def _dispatches(model, rng):
    """A prefill into pages 0-1, then 3 decode steps of slot 0 and a
    verify over slot 1's pages 2-3: (program, feeds, fetches) each."""
    s, v = model.max_slots, model.vocab_size
    trash = model.trash_page
    pt = np.full((s, model.pages_per_slot), trash, np.int64)
    pt[0, :2] = [0, 1]
    pt[1, :2] = [2, 3]
    prompt = rng.integers(2, v, (1, 8))
    out = [(model.prefill_program(8),
            {model.PF_TOKENS: prompt,
             model.PF_PAGES: np.array([0, 1], np.int64)}, [])]
    for t in range(3):
        pos = np.array([7 + t, 0, 0], np.int64)
        active = np.array([1, 0, 0], np.float32)
        out.append((model.step_program, {
            model.DC_TOKENS: rng.integers(2, v, (s, 1)),
            model.DC_POS: pos, model.DC_ACTIVE: active,
            model.DC_POSENC: model.posenc_rows(pos).astype(np.float32),
            model.DC_BIAS: model.validity_bias(pos), model.DC_PTABLE: pt,
            model.DC_WPAGE: np.array([1, trash, trash], np.int64),
            model.DC_WOFF: np.array([(7 + t) % 4, 0, 0], np.int64)},
            [model.step_fetch, model.logits_fetch]))
    k = 2
    prog, tok_f, nacc_f, logits_f = model.spec_program(k)
    feeds = {model.SP_DRAFT: rng.integers(2, v, (s, k)),
             model.SP_ACTIVE: np.array([0, 1, 0], np.float32),
             model.SP_PTABLE: pt}
    for j in range(k + 1):
        pos = np.array([0, 2 + j, 0], np.int64)
        feeds[model.SP_TOK.format(j)] = rng.integers(2, v, (s, 1))
        feeds[model.SP_PE.format(j)] = model.posenc_rows(pos).astype(
            np.float32)
        feeds[model.SP_BIAS_J.format(j)] = model.validity_bias(pos)
        feeds[model.SP_WROW.format(j)] = np.array([trash, 2, trash],
                                                  np.int64)
        feeds[model.SP_WOFF.format(j)] = np.array([0, 2 + j, 0], np.int64)
    out.append((prog, feeds, [tok_f, nacc_f, logits_f]))
    return out


def test_runner_outputs_bitwise_executor_run():
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **SHAPE)
    exe, a, b = _two_scopes(model)
    runners = {}
    for prog, feeds, fetches in _dispatches(model,
                                            np.random.default_rng(0)):
        want = exe.run(prog, feed=feeds, fetch_list=fetches, scope=a)
        key = (id(prog), tuple(fetches))
        if key not in runners:
            runners[key] = ProgramGraph(prog, feeds, fetches, b, CPU)
        got = runners[key].run(feeds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for v in model.startup.list_vars():
            if v.persistable:
                assert torch.equal(b.get(v.name), a.get(v.name)), v.name
    assert len(runners) == 3
    assert all(r.ready and r.graph.eager_steps >= 1
               for r in runners.values())
    # the dispatches wrote the caches: the check above was not vacuous
    assert b.get("dlm0_cache_k").abs().sum() > 0


def test_runners_of_one_scope_hold_the_same_tensors():
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **SHAPE)
    with DecodeEngine(model, DecodeConfig(spec=2), place=fluid.CPUPlace()
                      ) as eng:
        eng.warmup()
        draft_scope = eng._spec.draft.scope
        target = [r for r in eng._runners.values() if r.scope is eng.scope]
        draft = [r for r in eng._runners.values() if r.scope is draft_scope]
        # step + 2 prefill buckets + verify; draft step + 2 prefills
        assert len(target) == 4 and len(draft) == 3
        for runners, scope in ((target, eng.scope), (draft, draft_scope)):
            for r in runners:
                assert r.state
                for name, t in r.state.items():
                    assert t is scope.get(name), name
            caches = [{n: t for n, t in r.state.items() if "_cache_" in n}
                      for r in runners]
            assert all(c.keys() == caches[0].keys() for c in caches)
            for name in caches[0]:
                assert len({id(c[name]) for c in caches}) == 1
        n_layer = model.cfg.n_layer
        assert len([n for n in target[0].state if "_cache_" in n]) == \
            2 * n_layer
        # the draft's weights are its own tensors, equal to the target's
        for name in eng._spec.draft.model.weight_names():
            assert draft_scope.get(name) is not eng.scope.get(name)
            assert torch.equal(draft_scope.get(name), eng.scope.get(name))


@pytest.mark.parametrize("spec", [0, 2], ids=["plain", "spec"])
def test_compiles_and_executables_flat_after_warmup(spec):
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **SHAPE)
    with DecodeEngine(model, DecodeConfig(spec=spec),
                      place=fluid.CPUPlace()) as eng:
        n = eng.warmup()
        want = 1 + len(SHAPE["prefill_buckets"])
        if spec:
            want += 2 + len(SHAPE["prefill_buckets"])
        assert n == want == eng.executables()
        snap = eng.metrics.snapshot()
        assert snap["bucket_compiles"] == want
        assert snap["warmup_dispatches"] == want
        assert eng.warmup() == want
        rng = np.random.default_rng(2)
        jobs = [(rng.integers(2, model.vocab_size, int(m)).tolist(), 6)
                for m in rng.integers(1, 9, 6)]
        outs = [f.result(timeout=60)
                for f in [eng.submit(p, k) for p, k in jobs]]
        assert eng.wait_idle(30)
        assert all(outs)
        after = eng.metrics.snapshot()
        assert after["bucket_compiles"] == want
        assert eng.executables() == want
        assert after["dispatches"] > snap["dispatches"] + len(jobs)
    assert eng.executables() == 0  # shutdown dropped the graphs


def test_runner_refuses_a_program_that_rebinds_state():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", shape=[4], dtype="float32",
                        append_batch_size=False)
        w = layers.create_global_var([4], 1.0, "float32", persistable=True,
                                     name="w_state")
        layers.assign(np.ones(4, np.float32), output=w)
        y = layers.scale(x, scale=2.0)
    scope = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="in place"):
        ProgramGraph(prog, {"x": np.zeros(4, np.float32)}, [y.name], scope,
                     CPU)


def test_runner_refuses_a_replaced_scope_tensor():
    model = port_tf.DecodeModel(port_tf.decode_lm_config(), **SHAPE)
    exe, scope, _ = _two_scopes(model)
    prog, feeds, fetches = _dispatches(model, np.random.default_rng(1))[1]
    runner = ProgramGraph(prog, feeds, fetches, scope, CPU)
    runner.run(feeds)
    w = scope.get("dlm_out_w")
    w.copy_(w * 2)  # written in place: fine
    runner.run(feeds)
    scope.set("dlm_out_w", w.clone())
    with pytest.raises(RuntimeError, match="replaced"):
        runner.run(feeds)
    bad = dict(feeds)
    bad[model.DC_POS] = np.zeros((4,), np.int64)
    scope.set("dlm_out_w", w)
    with pytest.raises(ValueError, match="shape"):
        runner.run(bad)
    del bad[model.DC_POS]
    with pytest.raises(ValueError, match="missing"):
        runner.run(bad)
