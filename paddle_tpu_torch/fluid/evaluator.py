"""In-program evaluators (counterpart of ``paddle_tpu/fluid/evaluator.py``):
an evaluator keeps its running counters as persistable vars of the
program, which ops of the program update each run, so on the card they
stay on the card; ``reset`` zeroes them and ``eval`` computes the metric
from them, each through a small program run by the executor.  The
``chunk_eval`` / ``edit_distance`` / ``accuracy`` ops do each batch's
math (``fluid.metrics`` holds the host-side classes)."""

from __future__ import annotations

import numpy as np

from . import layers
from .framework import Program, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["ChunkEvaluator", "EditDistance", "Accuracy"]


class Evaluator:
    """States are persistable program vars; ``reset`` zeroes them through
    the executor, ``eval`` runs a small fetch program over them."""

    def __init__(self, name, **kwargs):
        self.states: list = []
        self.metrics: list = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                zeros = layers.fill_constant(
                    shape=list(var.shape), dtype=var.dtype, value=0.0)
                layers.assign(zeros, output=self._clone_into(reset_program,
                                                            var))
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def _clone_into(self, program, var):
        block = program.global_block()
        if not block.has_var(var.name):
            nv = block.create_var(name=var.name, shape=var.shape,
                                  dtype=var.dtype, persistable=True)
            return nv
        return block.var(var.name)

    def _create_state(self, suffix, dtype, shape):
        var = self.helper.create_global_variable(
            name="_".join([self.helper.name, suffix]), persistable=True,
            dtype=dtype, shape=list(shape))
        self.helper.set_variable_initializer(var, Constant(0.0))
        self.states.append(var)
        return var


class Accuracy(Evaluator):
    """Running accuracy: correct/total accumulated in-graph."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        self.total = self._create_state("total", "float32", [1])
        self.correct = self._create_state("correct", "float32", [1])
        acc = layers.accuracy(input=input, label=label, k=k)
        batch = layers.fill_constant_batch_size_like(
            input, shape=[-1, 1], dtype="float32", value=1.0)
        n = layers.reduce_sum(batch)  # = batch size, shape [1]
        correct_b = layers.elementwise_mul(acc, n)
        layers.assign(layers.elementwise_add(self.total, n),
                      output=self.total)
        layers.assign(layers.elementwise_add(self.correct, correct_b),
                      output=self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        with program_guard(main_program=eval_program):
            total = self._clone_into(eval_program, self.total)
            correct = self._clone_into(eval_program, self.correct)
            out = layers.elementwise_div(
                correct, layers.elementwise_max(
                    total, layers.fill_constant([1], "float32", 1e-6)))
        (v,) = executor.run(eval_program, fetch_list=[out])
        return np.asarray(v)


class ChunkEvaluator(Evaluator):
    """Running chunk F1: accumulates the chunk_eval op's per-batch counts
    into program state and derives P/R/F1."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_eval")
        self.num_infer = self._create_state("num_infer_chunks", "float32", [1])
        self.num_label = self._create_state("num_label_chunks", "float32", [1])
        self.num_correct = self._create_state("num_correct_chunks",
                                              "float32", [1])
        (precision, recall, f1, infer_c, label_c, correct_c) = \
            layers.chunk_eval(input=input, label=label,
                              chunk_scheme=chunk_scheme,
                              num_chunk_types=num_chunk_types,
                              excluded_chunk_types=excluded_chunk_types)
        for state, batch in ((self.num_infer, infer_c),
                             (self.num_label, label_c),
                             (self.num_correct, correct_c)):
            layers.assign(
                layers.elementwise_add(state, layers.cast(batch, "float32")),
                output=state)
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        with program_guard(main_program=eval_program):
            infer = self._clone_into(eval_program, self.num_infer)
            label = self._clone_into(eval_program, self.num_label)
            correct = self._clone_into(eval_program, self.num_correct)
            eps = layers.fill_constant([1], "float32", 1e-6)
            precision = layers.elementwise_div(
                correct, layers.elementwise_max(infer, eps))
            recall = layers.elementwise_div(
                correct, layers.elementwise_max(label, eps))
            two = layers.fill_constant([1], "float32", 2.0)
            f1 = layers.elementwise_div(
                layers.elementwise_mul(
                    two, layers.elementwise_mul(precision, recall)),
                layers.elementwise_max(
                    layers.elementwise_add(precision, recall), eps))
        p, r, f = executor.run(eval_program,
                               fetch_list=[precision, recall, f1])
        return np.asarray(p), np.asarray(r), np.asarray(f)


class EditDistance(Evaluator):
    """Running average edit distance and the share of sequences with any
    error."""

    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("edit_distance")
        self.total_distance = self._create_state("total_distance",
                                                 "float32", [1])
        self.seq_num = self._create_state("seq_num", "float32", [1])
        self.instance_error = self._create_state("instance_error",
                                                 "float32", [1])
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        zeros = layers.fill_constant_batch_size_like(
            distances, shape=[-1, 1], dtype="float32", value=0.0)
        errors = layers.cast(distances > zeros, "float32")  # math_op_patch
        layers.assign(layers.elementwise_add(
            self.total_distance, layers.reduce_sum(distances)),
            output=self.total_distance)
        layers.assign(layers.elementwise_add(
            self.seq_num, layers.cast(seq_num, "float32")),
            output=self.seq_num)
        layers.assign(layers.elementwise_add(
            self.instance_error, layers.reduce_sum(errors)),
            output=self.instance_error)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        with program_guard(main_program=eval_program):
            total = self._clone_into(eval_program, self.total_distance)
            n = self._clone_into(eval_program, self.seq_num)
            err = self._clone_into(eval_program, self.instance_error)
            eps = layers.fill_constant([1], "float32", 1e-6)
            avg = layers.elementwise_div(total,
                                         layers.elementwise_max(n, eps))
            ratio = layers.elementwise_div(err,
                                           layers.elementwise_max(n, eps))
        a, r = executor.run(eval_program, fetch_list=[avg, ratio])
        return np.asarray(a), np.asarray(r)
