"""Whole-loop beam search over static ``[batch, beam]`` state (counterpart
of ``paddle_tpu/ops/beam_search_jit.py`` and of
``control_flow_exec.run_jit_beam_search``): the engine of
``JitBeamSearchDecoder``'s ``jit_beam_search`` op.

Semantics are the eager ``beam_search`` op's (``ops/array_ops.py``), the
fixed-width formulation: a beam that has emitted ``end_id`` keeps one
candidate, ``end_id`` again at its frozen score, so an ended hypothesis
survives selection without re-accumulation.  Once every beam has ended, a
further step leaves every history row below ``n_steps`` unchanged (it
writes row ``n_steps`` only, and ``n_steps`` stops), so running more steps
than needed is exact.

The step (:func:`beam_search_step`): the cell's sub-block ops, log, the
ended-beam mask, the top ``beam`` of each source's ``beam * vocab``
candidates (a stable descending sort: ties go to the lower index, as
``lax.top_k`` breaks them; ``torch.topk`` promises no order), the gather
of the cell states along the chosen parents, and the history writes at a
device-held index ``t`` (``index_copy_``), which advances only while some
beam is alive.  :class:`JitEngine` runs it over static buffers through
``fluid/cuda_graph.py``'s :class:`StepGraph`: on the card the step is
captured once per (batch, beam, vocab, max_len, state shapes) at the first
decode (an eager warm-up step first, then the buffers reloaded) and every
later decode replays it step by step, with one pinned-memory read of
"every beam has ended" after each replay.  One graph a step rather than
one graph of all ``max_len`` steps: on an NVIDIA H100 80GB HBM3 (700 W) at
``bench.py``'s decode widths (batch 8, beam 4, vocab 1000, d 64,
max_len 16), with trained weights whose beams all end by step 3, a decode
took 1.46-2.02 ms this way against 2.90-2.92 ms for one whole-loop graph;
with the bench's random weights, where all 16 steps run, 3.63-4.25 ms
against 2.98-3.69 ms (``chip_smoke.py``'s ``decode_jit``, 20 warm decodes
a layout).  A decoder in use is trained, so its beams end early.  A
capture that fails raises: nothing falls back to eager steps on the card.
On the CPU the same steps run eagerly.

Each ``jit_beam_search`` op keeps its engines (one per decode shape) on
itself, so they and their graphs go with the program that holds the op.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .array_ops import NEG_INF

# what the engines did since the last reset
stats = {"captures": 0, "replays": 0, "flag_reads": 0, "steps": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def beam_search_step(step_fn: Callable, states: Sequence, tokens, scores,
                     finished, *, beam_size: int, vocab_size: int,
                     end_id: int):
    """One expansion: advance the cell, fan the candidates out, keep the
    top ``beam_size`` of each source, reorder the states along the
    parents.  tokens / scores / finished: [batch, beam]; states:
    [batch*beam, ...].  Returns ``(new_tokens, parents, new_scores,
    new_finished, new_states)``, parents int32."""
    b, k = tokens.shape
    v = int(vocab_size)
    probs, new_states = step_fn(states, tokens.reshape(b * k, 1))
    logp = torch.log(torch.clamp(probs.float(), min=1e-30))
    cand = scores[:, :, None] + logp.reshape(b, k, v)
    cand = torch.where(finished[:, :, None],
                       torch.full_like(cand, NEG_INF), cand)
    cand[:, :, end_id] = torch.where(finished, scores, cand[:, :, end_id])
    top_sc, top_idx = torch.sort(cand.reshape(b, k * v), dim=1,
                                 descending=True, stable=True)
    top_sc, top_idx = top_sc[:, :k], top_idx[:, :k]
    parent = top_idx // v
    new_tok = top_idx % v
    new_fin = torch.gather(finished, 1, parent) | (new_tok == end_id) \
        | (top_sc <= NEG_INF / 2)
    rows = (torch.arange(b, device=tokens.device)[:, None] * k
            + parent).reshape(-1)
    new_states = [s[rows] for s in new_states]
    return new_tok, parent.to(torch.int32), top_sc, new_fin, new_states


class JitEngine:
    """Static buffers for one decode shape and the graph of its step.
    ``run_body(env)`` runs the cell's sub-block against an env of tensors;
    ``names``: (id feed, state feeds, state outs, context feeds, prob var,
    loop-invariant input names)."""

    def __init__(self, device, run_body, names, batch, beam, vocab, max_len,
                 end_id, init_states, ctx, xs, generators=()):
        from ..fluid.cuda_graph import StepGraph

        (self.id_feed, self.state_feeds, self.state_outs, self.ctx_feeds,
         self.prob_var, self.x_names) = names
        self.device = torch.device(device)
        self.run_body = run_body
        self.b, self.k, self.v, self.length = batch, beam, vocab, max_len
        self.end_id = end_id
        dev = self.device
        b, k = batch, beam
        self.tokens = torch.zeros((b, k), dtype=torch.int64, device=dev)
        self.scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
        self.finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        self.states = [torch.empty((b * k,) + tuple(s.shape[1:]),
                                   dtype=s.dtype, device=dev)
                       for s in init_states]
        self.ctx = [torch.empty((b * k,) + tuple(c.shape[1:]),
                                dtype=c.dtype, device=dev) for c in ctx]
        self.xs = [torch.empty_like(x, device=dev) for x in xs]
        n = max_len + 1
        self.h_ids = torch.zeros((n, b, k), dtype=torch.int64, device=dev)
        self.h_par = torch.zeros((n, b, k), dtype=torch.int32, device=dev)
        self.h_sc = torch.zeros((n, b, k), dtype=torch.float32, device=dev)
        self.t = torch.ones((1,), dtype=torch.int64, device=dev)
        self.flag = (torch.zeros((1,), dtype=torch.bool, pin_memory=True)
                     if dev.type == "cuda" else None)
        self.graph = StepGraph(self._graph_step, dev, generators)

    def _step_fn(self, states, tokens):
        env = dict(zip(self.x_names, self.xs))
        env[self.id_feed] = tokens
        env.update(zip(self.state_feeds, states))
        env.update(zip(self.ctx_feeds, self.ctx))
        self.run_body(env)
        return env[self.prob_var], [env[n] for n in self.state_outs]

    def _graph_step(self):
        alive = ~self.finished.all()
        new_tok, parent, top_sc, new_fin, new_states = beam_search_step(
            self._step_fn, self.states, self.tokens, self.scores,
            self.finished, beam_size=self.k, vocab_size=self.v,
            end_id=self.end_id)
        self.h_ids.index_copy_(0, self.t, new_tok[None])
        self.h_par.index_copy_(0, self.t, parent[None])
        self.h_sc.index_copy_(0, self.t, top_sc[None])
        self.tokens.copy_(new_tok)
        self.scores.copy_(top_sc)
        self.finished.copy_(new_fin)
        for s, ns in zip(self.states, new_states):
            s.copy_(ns)
        self.t.add_(alive.to(torch.int64))

    def load(self, init_ids, init_scores, init_states, ctx, xs):
        """The decode's inputs into the static buffers; beam 0 of each
        source carries its init hypothesis, the others are dead until the
        first expansion fans out."""
        k = self.k
        ids = init_ids.reshape(self.b, 1).to(torch.int64)
        self.tokens.copy_(ids.expand(self.b, k))
        self.scores.fill_(NEG_INF)
        self.scores[:, 0] = init_scores.reshape(self.b).to(torch.float32)
        self.finished.zero_()
        for buf, s in zip(self.states, init_states):
            buf.copy_(torch.repeat_interleave(s, k, dim=0))
        for buf, c in zip(self.ctx, ctx):
            buf.copy_(torch.repeat_interleave(c, k, dim=0))
        for buf, x in zip(self.xs, xs):
            buf.copy_(x)
        self.h_ids.zero_()
        self.h_par.zero_()
        self.h_sc.fill_(NEG_INF)
        self.h_ids[0] = self.tokens
        self.h_sc[0] = self.scores
        self.t.fill_(1)

    def decode(self, *inputs):
        """(hist_ids, hist_parents, hist_scores, n_steps) of one decode:
        [max_len + 1, batch, beam] histories (row 0 the init step) and the
        count of valid rows."""
        graph = self.graph
        if self.device.type == "cuda" and not graph.warm:
            self.load(*inputs)
            graph.run(1)  # the eager warm-up; the capture comes next
        self.load(*inputs)
        had_graph, replays = graph.graph is not None, graph.replays
        for step in range(self.length):
            graph.run(1)
            stats["flag_reads"] += 1
            if self._all_finished():
                break
        if graph.graph is not None and not had_graph:
            stats["captures"] += 1
        stats["replays"] += graph.replays - replays
        stats["steps"] += step + 1
        return self.h_ids, self.h_par, self.h_sc, self.t.to(torch.int32)

    def _all_finished(self) -> bool:
        if self.flag is None:
            return bool(self.finished.all())
        self.flag.copy_(self.finished.all().reshape(1), non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return bool(self.flag[0])


def _shape_key(ts: List[torch.Tensor]):
    return tuple((tuple(t.shape), t.dtype) for t in ts)


def run_jit_beam_search(op, env: Dict[str, object], device, generator,
                        run_op):
    """The ``jit_beam_search`` op: the decode of its step sub-block over
    its inputs, the histories and the step count into its outputs."""
    body = op.block.program.block(op.attr("sub_block"))
    beam = int(op.attr("beam_size"))
    init_name = op.inputs["InitIds"][0]
    init_ids = env[init_name]
    init_lod = env.get(init_name + "@LOD")
    if init_lod:
        lvl0 = list(init_lod[0])
        if lvl0 and lvl0 != list(range(len(lvl0))):
            raise ValueError(
                "jit_beam_search: init_ids must carry exactly one init "
                f"hypothesis per source (lod level 0 {lvl0}); multi-"
                "hypothesis warm starts need the eager BeamSearchDecoder")
    missing = [n for n in op.inputs.get("X", []) if n and n not in env]
    if missing:
        raise RuntimeError(
            f"jit_beam_search: loop-invariant inputs {missing} are not in "
            f"scope — was the startup program run, and are all captured "
            f"vars produced before this op?")

    def _t(v):
        return torch.from_numpy(np.array(v)).to(device) \
            if isinstance(v, np.ndarray) else v

    init_ids = _t(init_ids)
    init_scores = _t(env[op.inputs["InitScores"][0]])
    init_states = [_t(env[n]) for n in op.inputs.get("StateInit", []) if n]
    ctx = [_t(env[n]) for n in op.inputs.get("Context", []) if n]
    x_names = [n for n in op.inputs.get("X", []) if n]
    xs = [_t(env[n]) for n in x_names]
    batch = int(init_ids.shape[0])
    key = (str(device), batch, _shape_key(init_states), _shape_key(ctx),
           _shape_key(xs))
    engines = getattr(op, "_jit_engines", None)
    if engines is None:
        engines = op._jit_engines = {}
    eng = engines.get(key)
    if eng is None:
        def run_body(env2):
            for bop in body.ops:
                run_op(bop, env2, device, generator)

        names = (op.attr("id_feed"), list(op.attr("state_feeds") or []),
                 list(op.attr("state_outs") or []),
                 list(op.attr("ctx_feeds") or []), op.attr("prob_var"),
                 x_names)
        eng = engines[key] = JitEngine(
            device, run_body, names, batch, beam,
            int(op.attr("vocab_size")), int(op.attr("max_len")),
            int(op.attr("end_id")), init_states, ctx, xs,
            [generator] if generator is not None else [])
    h_ids, h_par, h_sc, n_steps = eng.decode(init_ids, init_scores,
                                             init_states, ctx, xs)
    env[op.outputs["HistIds"][0]] = h_ids
    env[op.outputs["HistParents"][0]] = h_par
    env[op.outputs["HistScores"][0]] = h_sc
    env[op.outputs["NumSteps"][0]] = n_steps
