"""One program dispatched many times over a scope's own tensors: eagerly on
the CPU, on the card as one CUDA graph replayed a dispatch (the counterpart
of one entry of the reference's jit cache, which the decode engine holds
closed after ``warmup()``: ``paddle_tpu/serving/decode.py:662-676``).

:class:`ProgramGraph` is what the decode engine dispatches: the step, each
prefill bucket, the speculative draft's step and prefills, and the verify
each get one.  Unlike ``Executor.run_steps``'s window, which copies a
scope value into a buffer of its own, it ADOPTS the scope's tensors: every
weight and KV cache a program reads is the scope's tensor object itself,
so all the graphs of one scope read and write the same device memory and
no dispatch copies state.  That asks two things of the program and its
caller:

 - every persistable the program writes is updated in place (the decode
   programs' ``kv_cache_update`` / ``kv_cache_scatter``); a program that
   would rebind one raises when its runner is built;
 - nothing replaces a scope tensor a runner holds (weights are written
   with ``copy_``); a dispatch that finds one replaced raises.

A dispatch copies the host feeds into static feed buffers (through pinned
host buffers on the card), runs the step (``fluid/cuda_graph.py``
``StepGraph``: the first dispatch eagerly, the second captured once and
then one replay a dispatch), and copies the fetches to the host.  There is
no eager path on the card: a program that cannot be captured raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import core
from .cuda_graph import StepGraph
from .executor import (BlockPlan, _execute, _live_ops, _snapshot, _storage,
                       op_is_eager)

__all__ = ["ProgramGraph"]


class ProgramGraph:
    """``program`` with the feeds of ``feeds`` (name -> array: the shapes a
    dispatch feeds) and ``fetch_names``, over ``scope`` on ``device``."""

    def __init__(self, program, feeds: Dict[str, np.ndarray],
                 fetch_names: Sequence[str], scope, device):
        self.device = torch.device(device)
        self.fetch_names = list(fetch_names)
        self.scope = scope
        block = program.global_block()
        if any(op_is_eager(op) for op in _live_ops(block, self.fetch_names)):
            raise RuntimeError("ProgramGraph: the program holds data-"
                               "dependent eager ops, which a graph cannot "
                               "capture")
        plan = BlockPlan(program, list(feeds), self.fetch_names)
        if plan.needs_rng:
            raise RuntimeError("ProgramGraph: the program draws random "
                               "numbers; dispatch it with Executor.run")
        self.plan = plan
        self.state: Dict[str, torch.Tensor] = {}
        for name in plan.state_in:
            if name in feeds:
                continue
            val = scope.get(name)
            if not isinstance(val, torch.Tensor):
                raise RuntimeError(
                    f"var {name!r} is neither fed nor a tensor in the scope "
                    f"(run the startup program first?)")
            if val.device != self.device:
                raise RuntimeError(f"var {name!r} lies on {val.device}, not "
                                   f"on {self.device}")
            self.state[name] = val
        rebound = [n for n in plan.state_out
                   if n not in self.state or n not in plan.in_place_names]
        if rebound:
            raise RuntimeError(
                f"ProgramGraph: the program writes {rebound} without "
                f"updating the scope's tensor in place; a graph over the "
                f"scope's own tensors cannot hold that")
        self.feed_bufs: Dict[str, torch.Tensor] = {}
        for name, arr in feeds.items():
            var = block._var_recursive(name)
            self.feed_bufs[name] = torch.empty(
                tuple(np.shape(arr)), dtype=core.torch_dtype(var.dtype),
                device=self.device)
        on_card = self.device.type == "cuda"
        # pinned staging: the feed copies leave the host at once, and a
        # dispatch ends synchronised, so a buffer is free again after it
        self._feed_host = {
            n: torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
            for n, b in self.feed_bufs.items()} if on_card else {}
        self._fetch_host: List[torch.Tensor] = []
        self.fetched: List[torch.Tensor] = []
        self.graph = StepGraph(self._step, self.device)

    @property
    def ready(self) -> bool:
        """True once a dispatch is one replay (on the CPU: once it ran)."""
        if self.device.type == "cuda":
            return self.graph.graph is not None
        return self.graph.eager_steps > 0

    def _step(self):
        env: Dict[str, object] = dict(self.state)
        env.update(self.feed_bufs)
        env.update(self.plan.consts)
        _execute(self.plan, env, self.device, None, self.fetch_names)
        for name in self.plan.state_out:
            if _storage(env[name]) != _storage(self.state[name]):
                raise RuntimeError(f"ProgramGraph: {name!r} was not updated "
                                   f"in place")
        self.fetched = [env[n] for n in self.fetch_names]

    def _stage(self, feeds) -> None:
        for name, buf in self.feed_bufs.items():
            arr = feeds.get(name)
            if arr is None:
                raise ValueError(f"ProgramGraph: feed {name!r} is missing")
            if tuple(np.shape(arr)) != tuple(buf.shape):
                raise ValueError(
                    f"ProgramGraph: feed {name!r} has shape "
                    f"{tuple(np.shape(arr))}; this graph takes "
                    f"{tuple(buf.shape)}")
            host = self._feed_host.get(name)
            if host is None:
                buf.copy_(torch.as_tensor(np.asarray(arr)))
            else:
                host.numpy()[...] = arr
                buf.copy_(host, non_blocking=True)

    def run(self, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """One dispatch: returns the fetches as numpy arrays."""
        for name, val in self.state.items():
            if self.scope.get(name) is not val:
                raise RuntimeError(
                    f"ProgramGraph: the scope's {name!r} was replaced; a "
                    f"runner holds its tensor (write weights with copy_)")
        self._stage(feeds)
        self.graph.run(1)
        if self.device.type != "cuda":
            return [_snapshot(t) for t in self.fetched]
        if not self._fetch_host:
            self._fetch_host = [torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
                                for t in self.fetched]
        for host, t in zip(self._fetch_host, self.fetched):
            host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy().copy() for h in self._fetch_host]

    def close(self) -> None:
        """Drop the graph and its memory pool."""
        self.graph.close()
        self.fetched = []
