"""One step function, run many times: eagerly on the CPU, on the card as one
CUDA graph replayed a step (the PyTorch counterpart of the reference's
``lax.scan`` over a traced step, ``paddle_tpu/fluid/executor.py:296``).

:class:`StepGraph` knows nothing of programs or training: it takes a
function of no arguments that reads and writes only tensors whose
addresses do not change from call to call (static buffers), and runs it
``n`` times.  ``Executor.run_steps`` gives it one training step; a decode
tick can be given the same way.

On a CUDA device:

 - the first call runs eagerly on a side stream: kernels build at their
   first use, cuBLAS / cuDNN / autograd set themselves up, and anything
   made lazily (a kernel's scratch) is made outside the capture, as
   ``torch.cuda.graph`` requires;
 - the second call is captured once on that stream into a
   ``torch.cuda.CUDAGraph`` with a memory pool of its own, and every call
   from then on (the second included: a capture runs nothing) is one
   replay;
 - the generators the step draws from are registered with the graph
   (``register_generator_state``): each replay draws fresh numbers and
   advances them as an eager call would;
 - the kernel wrappers' launch counters (``ops/launch_counts.py``) move
   only while the step is captured, so what the capture added is taken
   back and added again once per replay.

There is no eager fallback on the card: a step that cannot be captured
raises.  ``before_step(i)`` runs before each call outside the graph (a
caller copies step ``i``'s feed into its static buffer there).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import launch_counts

__all__ = ["StepGraph"]


class StepGraph:
    """Runs ``step`` (no arguments, static buffers only) on ``device``.

    Attributes after a capture: ``capture_s`` (the capture's host time),
    ``pool_bytes`` (device memory the caching allocator reserved for the
    graph's pool), ``launch_delta`` (the wrappers' launches a replay
    makes); always ``eager_steps`` and ``replays``."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self._step = step
        self.device = torch.device(device)
        self._generators = list(generators)
        self._stream: Optional[torch.cuda.Stream] = None
        self.graph = None
        self.warm = False
        self.eager_steps = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.launch_delta = {}

    def run(self, n: int, before_step: Optional[Callable[[int], None]] = None
            ) -> None:
        for i in range(n):
            if before_step is not None:
                before_step(i)
            if self.device.type != "cuda":
                self._step()
                self.eager_steps += 1
            elif not self.warm:
                self._warm_up()
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                launch_counts.add(self.launch_delta)
                self.replays += 1

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm_up(self) -> None:
        side, cur = self._side_stream(), torch.cuda.current_stream(
            self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._step()
        cur.wait_stream(side)
        self.warm = True
        self.eager_steps += 1

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = launch_counts.snapshot()
        t0 = time.perf_counter()
        # thread_local: another thread (an input prefetcher) may stage
        # host copies while this one captures
        with torch.cuda.graph(graph, stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            self._step()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.launch_delta = launch_counts.delta(before,
                                                launch_counts.snapshot())
        launch_counts.add(self.launch_delta, -1)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph

    def close(self) -> None:
        """Drop the graph (its pool goes once no tensor of it is held)."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
        self.graph = None
        self._stream = None
