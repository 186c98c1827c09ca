"""User-facing seq2seq decoder DSL (counterpart of
``paddle_tpu/fluid/contrib/decoder/beam_search_decoder.py``): InitState /
StateCell / TrainingDecoder / BeamSearchDecoder / JitBeamSearchDecoder,
with the reference's public API (ref: python/paddle/fluid/contrib/decoder/
beam_search_decoder.py:43,159,384,523).

A StateCell describes an RNN cell abstractly: named step inputs, named
hidden states with their initializers, and a user-supplied updater that maps
(inputs, states) -> new states.  The SAME cell drives three harnesses:

 - TrainingDecoder: teacher-forced unrolling over a LoD step input, backed
   by layers.DynamicRNN (states live in rnn memories, outputs become a
   packed LoDTensor);
 - BeamSearchDecoder: a While generation loop, where states live in tensor
   arrays indexed by the step counter and each step expands hypotheses with
   layers.beam_search (on the host), terminating early once every beam
   emits end_id;
 - JitBeamSearchDecoder: the cell's single step in a sub-block, run by one
   ``jit_beam_search`` op over static [batch, beam] state
   (ops/beam_search_jit.py): on the card a CUDA graph replayed, with the
   LoD packaging the one host op after it.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ... import layers, unique_name
from ...framework import Variable
from ...layer_helper import LayerHelper

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder",
           "JitBeamSearchDecoder"]

_TRAINING, _BEAM, _JIT = "training", "beam_search", "jit_beam_search"


def _loop_array(helper, init, zero_idx):
    """Create a tensor array holding ``init`` at index 0, with BOTH the
    create and the init write placed in the block ENCLOSING the current
    (While-body) block: loop-carried arrays must exist before the first
    iteration reads them."""
    from ... import core

    program = helper.main_program
    parent_idx = program.current_block().parent_idx
    block = program.block(parent_idx) if parent_idx >= 0 \
        else program.current_block()
    array = block.create_var(
        name=unique_name.generate("beam_decoder_array"),
        dtype=init.dtype, type=core.VarType.LOD_TENSOR_ARRAY)
    if getattr(init, "shape", None) is not None:
        array.shape = tuple(init.shape)
    block.append_op(type="write_to_array",
                    inputs={"X": [init], "I": [zero_idx]},
                    outputs={"Out": [array]})
    return array


class InitState:
    """Initial value of one hidden state (ref :43).  Either an explicit
    ``init`` Variable, or a constant tensor shaped like ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is not None:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        else:
            raise ValueError(
                "InitState needs `init` or `init_boot` to determine shape")
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _RnnMemoryBacking:
    """State storage inside a TrainingDecoder: a DynamicRNN memory."""

    def __init__(self, rnn, init_state: InitState):
        self._rnn = rnn
        self._mem = rnn.memory(init=init_state.value,
                               need_reorder=init_state.need_reorder)

    def current(self):
        return self._mem

    def commit(self, new_value):
        self._rnn.update_memory(self._mem, new_value)


class _ArrayBacking:
    """State storage inside a BeamSearchDecoder: a tensor array indexed by
    the decoder's own step counter (written at counter+1 each step)."""

    def __init__(self, decoder, init_state: InitState):
        self._decoder = decoder
        self._array = _loop_array(decoder._helper, init_state.value,
                                  decoder._zero_idx)

    def current(self):
        return layers.array_read(array=self._array,
                                 i=self._decoder._counter)

    def commit(self, new_value):
        self._decoder._deferred_writes.append((new_value, self._array))


class StateCell:
    """Abstract RNN cell: named inputs + named states + an updater
    (ref :159).  ``out_state`` names the state whose value scores tokens."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        for v in states.values():
            if not isinstance(v, InitState):
                raise ValueError("every state must be an InitState")
        if out_state not in states:
            raise ValueError(f"out_state {out_state!r} not among states")
        self._init_states = dict(states)
        self._inputs = dict(inputs)
        self._out_state = out_state
        self._updater = None
        self._decoder = None
        self._backings = {}
        self._cur = {}

    # -- decoder attach/detach (TrainingDecoder/BeamSearchDecoder call these)
    def _enter_decoder(self, decoder):
        if self._decoder is not None:
            raise ValueError("StateCell is already attached to a decoder")
        self._decoder = decoder
        self._backings = {}
        self._cur = {}

    def _leave_decoder(self, decoder):
        if self._decoder is not decoder:
            raise ValueError("StateCell attached to a different decoder")
        self._decoder = None

    def _materialize(self):
        """Lazily create per-decoder state storage and read current values."""
        if self._backings or self._decoder is None:
            return
        for name, init in self._init_states.items():
            b = self._decoder._make_backing(name, init)
            self._backings[name] = b
            self._cur[name] = b.current()

    # -- user surface
    def get_state(self, state_name):
        self._materialize()
        if state_name not in self._cur:
            raise ValueError(f"unknown state {state_name!r}")
        return self._cur[state_name]

    def get_input(self, input_name):
        v = self._inputs.get(input_name)
        if v is None:
            raise ValueError(f"input {input_name!r} has not been provided")
        return v

    def set_state(self, state_name, state_value):
        self._cur[state_name] = state_value

    def state_updater(self, updater):
        """Decorator registering fn(state_cell) that computes new states via
        get_input/get_state + set_state."""
        self._updater = updater
        return updater

    def compute_state(self, inputs):
        self._materialize()
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError(f"unknown input {name!r}")
            self._inputs[name] = value
        if self._updater is None:
            raise ValueError("no state_updater registered")
        self._updater(self)

    def update_states(self):
        for name, backing in self._backings.items():
            backing.commit(self._cur[name])

    def out_state(self):
        return self._cur[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoder over a LoD target sequence (ref :384);
    a thin harness around layers.DynamicRNN driven by a StateCell."""

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._rnn = layers.DynamicRNN()
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._done = False

    type = _TRAINING

    def _make_backing(self, name, init_state):
        return _RnnMemoryBacking(self._rnn, init_state)

    @property
    def dynamic_rnn(self):
        return self._rnn

    @property
    def state_cell(self):
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        with self._rnn.block():
            yield
        self._done = True
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        return self._rnn.static_input(x)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if not self._done:
            raise ValueError("visit TrainingDecoder output after block()")
        return self._rnn(*args, **kwargs)


class BeamSearchDecoder:
    """Generation-time beam search harness (ref :523).

    ``decode()`` builds the canonical loop: read back last step's live
    hypotheses, expand cell states to the live beam width
    (sequence_expand over the scores' LoD), advance the cell one step,
    project ``out_state`` to vocab scores, pick beam_size survivors with
    layers.beam_search, and stop early when every beam has ended.  Override
    decode() for a custom loop; __call__ backtracks the full hypotheses
    with layers.beam_search_decode."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._beam_size = beam_size
        self._end_id = end_id

        self._counter = layers.zeros(shape=[1], dtype="int64")
        self._counter.stop_gradient = True
        self._zero_idx = layers.fill_constant(shape=[1], dtype="int64",
                                              value=0, force_cpu=True)
        self._max_len = layers.fill_constant(shape=[1], dtype="int64",
                                             value=max_len)
        self._cond = layers.less_than(x=self._counter, y=self._max_len)
        self._while = layers.While(self._cond)
        self._deferred_writes = []
        self._tracked = {}     # read-value name -> backing array
        self._ids_array = None
        self._scores_array = None
        self._done = False
        self._state_cell._enter_decoder(self)

    type = _BEAM

    def _make_backing(self, name, init_state):
        return _ArrayBacking(self, init_state)

    @property
    def state_cell(self):
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        """One While iteration; deferred array writes land at counter+1 so
        the next iteration reads this step's survivors."""
        with self._while.block():
            yield
            with layers.Switch() as switch:
                with switch.case(self._cond):
                    layers.increment(x=self._counter, value=1,
                                     in_place=True)
                    for value, array in self._deferred_writes:
                        layers.array_write(x=value, i=self._counter,
                                           array=array)
                    layers.less_than(x=self._counter, y=self._max_len,
                                     cond=self._cond)
        self._done = True
        self._state_cell._leave_decoder(self)

    def early_stop(self):
        layers.fill_constant(shape=[1], value=0, dtype="bool",
                             force_cpu=True, out=self._cond)

    def read_array(self, init, is_ids=False, is_scores=False):
        """Array-backed loop variable: initialized before the loop, read at
        the counter, rewritten via update_array each live step."""
        if is_ids and is_scores:
            raise ValueError("an array is either ids or scores, not both")
        if not isinstance(init, Variable):
            raise TypeError("read_array init must be a Variable")
        array = _loop_array(self._helper, init, self._zero_idx)
        if is_ids:
            self._ids_array = array
        elif is_scores:
            self._scores_array = array
        value = layers.array_read(array=array, i=self._counter)
        self._tracked[value.name] = array
        return value

    def update_array(self, array, value):
        backing = self._tracked.get(array.name)
        if backing is None:
            raise ValueError("update_array target was not read_array'd")
        self._deferred_writes.append((value, backing))

    def decode(self):
        cell = self._state_cell
        with self.block():
            prev_ids = self.read_array(init=self._init_ids, is_ids=True)
            prev_scores = self.read_array(init=self._init_scores,
                                          is_scores=True)
            prev_emb = layers.embedding(
                prev_ids, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb)

            feeds = {}
            tracked_inputs = {}
            for name, var in self._input_var_dict.items():
                if name not in cell._inputs:
                    raise ValueError(
                        f"input_var_dict key {name!r} unknown to the cell")
                stored = self.read_array(init=var)
                tracked_inputs[name] = stored
                feeds[name] = layers.sequence_expand(stored, prev_scores)
            for name in cell._inputs:
                if name not in feeds:
                    feeds[name] = prev_emb
            # live beam width changes step to step: stretch every state
            # over the current hypotheses (parents repeat per child)
            for sname in cell._init_states:
                cell.set_state(
                    sname,
                    layers.sequence_expand(cell.get_state(sname),
                                           prev_scores))

            cell.compute_state(inputs=feeds)
            out = layers.lod_reset(x=cell.out_state(), y=prev_scores)
            scores = layers.fc(input=out, size=self._target_dict_dim,
                               act="softmax")
            topk_scores, topk_indices = layers.topk(scores,
                                                    k=self._topk_size)
            accu = layers.elementwise_add(
                x=layers.log(topk_scores),
                y=layers.reshape(prev_scores, shape=[-1]), axis=0)
            sel_ids, sel_scores = layers.beam_search(
                prev_ids, prev_scores, topk_indices, accu,
                self._beam_size, end_id=self._end_id, level=0)

            with layers.Switch() as switch:
                with switch.case(layers.is_empty(sel_ids)):
                    self.early_stop()
                with switch.default():
                    cell.update_states()
                    self.update_array(prev_ids, sel_ids)
                    self.update_array(prev_scores, sel_scores)
                    for name, stored in tracked_inputs.items():
                        self.update_array(stored, feeds[name])

    def __call__(self):
        if not self._done:
            raise ValueError("run decode() (or block()) before calling")
        return layers.beam_search_decode(ids=self._ids_array,
                                         scores=self._scores_array,
                                         beam_size=self._beam_size,
                                         end_id=self._end_id)


class _JitBacking:
    """State storage inside a JitBeamSearchDecoder: a placeholder variable
    in the step sub-block.  The jit_beam_search engine feeds it each step
    and reads the committed output name."""

    def __init__(self, decoder, name, init_state: InitState):
        init = init_state.value
        shape = (-1,) + tuple(init.shape[1:]) if init.shape else (-1,)
        self._ph = decoder._step_block.create_var(
            name=unique_name.generate(f"jbs_state_{name}"),
            dtype=init.dtype, shape=shape)
        self._decoder = decoder
        self._name = name
        decoder._register_state(name, init, self._ph)

    def current(self):
        return self._ph

    def commit(self, new_value):
        self._decoder._commit_state(self._name, new_value)


class JitBeamSearchDecoder:
    """Generation harness over static shapes: the SAME StateCell as
    BeamSearchDecoder, but ``decode()`` builds the cell's single step into
    a sub-block of placeholder variables and appends one
    ``jit_beam_search`` op that runs it over static [batch, beam] state
    with a finished-mask early exit (ops/beam_search_jit.py), then one
    ``beam_search_pack`` op.  ``__call__`` returns the same 2-level-LoD
    (ids, scores) pair as BeamSearchDecoder.

    Contract notes:
     - every source sentence decodes ``beam_size`` hypotheses (the eager
       op is fixed-width too, so results agree);
     - per-sentence tensors the cell consumes (encoder context) must be
       passed via ``input_var_dict``; they are tiled beam-wide ONCE,
       outside the loop (the eager path re-expands per step instead);
     - the cell updater must use only ops with no host reads (true for
       every standard RNN/attention cell).
    """

    type = _JIT

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        # topk_size/sparse_emb accepted for BeamSearchDecoder signature
        # parity: global top-k over beam*vocab subsumes the per-beam
        # topk_size prefilter whenever beam_size <= topk_size, and the
        # step's embedding is dense.
        self._helper = LayerHelper("jit_beam_search_decoder", name=name)
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._beam_size = beam_size
        self._max_len = max_len
        self._end_id = end_id
        self._state_names = []      # registration order == engine order
        self._state_inits = {}
        self._state_phs = {}
        self._state_out_names = {}
        self._step_block = None
        self._outputs = None
        self._state_cell._enter_decoder(self)

    @property
    def state_cell(self):
        return self._state_cell

    def _make_backing(self, name, init_state):
        return _JitBacking(self, name, init_state)

    def _register_state(self, name, init, ph):
        self._state_names.append(name)
        self._state_inits[name] = init
        self._state_phs[name] = ph

    def _commit_state(self, name, new_value):
        self._state_out_names[name] = new_value.name

    def decode(self):
        if self._outputs is not None:
            raise ValueError("decode() already ran for this decoder")
        try:
            return self._decode()
        except Exception:
            # detach so the cell can be reused by another decoder after a
            # failed build (mirrors BeamSearchDecoder.block's unwind)
            if self._state_cell._decoder is self:
                self._state_cell._leave_decoder(self)
            raise

    def _decode(self):
        cell = self._state_cell
        program = self._helper.main_program
        parent_block = program.current_block()
        self._step_block = program._create_block()  # now current
        try:
            id_feed = self._step_block.create_var(
                name=unique_name.generate("jbs_prev_ids"),
                dtype="int64", shape=(-1, 1))
            prev_emb = layers.embedding(
                id_feed, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=False)

            feeds = {}
            ctx_phs, ctx_vars = [], []
            for name, var in self._input_var_dict.items():
                if name not in cell._inputs:
                    raise ValueError(
                        f"input_var_dict key {name!r} unknown to the cell")
                ph = self._step_block.create_var(
                    name=unique_name.generate(f"jbs_ctx_{name}"),
                    dtype=var.dtype,
                    shape=(-1,) + tuple((var.shape or ())[1:]))
                ctx_phs.append(ph.name)
                ctx_vars.append(var.name)
                feeds[name] = ph
            for name in cell._inputs:
                if name not in feeds:
                    feeds[name] = prev_emb

            cell.compute_state(inputs=feeds)
            cell.update_states()
            probs = layers.fc(input=cell.out_state(),
                              size=self._target_dict_dim, act="softmax")
        finally:
            program._rollback()

        # loop-invariant values the step reads but does not define:
        # parameters and any batch-independent captures
        defined = {id_feed.name} | set(self._state_phs[n].name
                                       for n in self._state_names)
        defined |= set(ctx_phs)
        written, x_names = set(), []
        for op in self._step_block.ops:
            for n in op.input_arg_names:
                if n and n not in written and n not in defined \
                        and n not in x_names \
                        and parent_block._has_var_recursive(n):
                    x_names.append(n)
            written.update(n for n in op.output_arg_names if n)

        def _out(name, dtype, shape):
            v = parent_block.create_var(
                name=unique_name.generate(name), dtype=dtype, shape=shape)
            v.stop_gradient = True
            return v

        L = self._max_len
        h_ids = _out("jbs_hist_ids", "int64", (L + 1, -1, self._beam_size))
        h_par = _out("jbs_hist_par", "int32", (L + 1, -1, self._beam_size))
        h_sc = _out("jbs_hist_sc", "float32",
                    (L + 1, -1, self._beam_size))
        n_steps = _out("jbs_nsteps", "int32", (1,))
        parent_block.append_op(
            type="jit_beam_search",
            inputs={"InitIds": [self._init_ids.name],
                    "InitScores": [self._init_scores.name],
                    "StateInit": [self._state_inits[n].name
                                  for n in self._state_names],
                    "Context": ctx_vars,
                    "X": x_names},
            outputs={"HistIds": [h_ids.name],
                     "HistParents": [h_par.name],
                     "HistScores": [h_sc.name],
                     "NumSteps": [n_steps.name]},
            attrs={"sub_block": self._step_block.idx,
                   "id_feed": id_feed.name,
                   "state_feeds": [self._state_phs[n].name
                                   for n in self._state_names],
                   "state_outs": [self._state_out_names[n]
                                  for n in self._state_names],
                   "ctx_feeds": ctx_phs,
                   "prob_var": probs.name,
                   "beam_size": int(self._beam_size),
                   "max_len": int(self._max_len),
                   "end_id": int(self._end_id),
                   "vocab_size": int(self._target_dict_dim)})

        out_ids = parent_block.create_var(
            name=unique_name.generate("jbs_sentence_ids"), dtype="int64",
            shape=(-1, 1), lod_level=2)
        out_scores = parent_block.create_var(
            name=unique_name.generate("jbs_sentence_scores"),
            dtype="float32", shape=(-1, 1), lod_level=2)
        out_ids.stop_gradient = out_scores.stop_gradient = True
        parent_block.append_op(
            type="beam_search_pack",
            inputs={"HistIds": [h_ids.name], "HistParents": [h_par.name],
                    "HistScores": [h_sc.name], "NumSteps": [n_steps.name]},
            outputs={"SentenceIds": [out_ids.name],
                     "SentenceScores": [out_scores.name]},
            attrs={"end_id": int(self._end_id)})
        self._outputs = (out_ids, out_scores)
        self._state_cell._leave_decoder(self)
        return self._outputs

    def __call__(self):
        if self._outputs is None:
            raise ValueError("run decode() before calling the decoder")
        return self._outputs
