"""PS dispatchers (counterpart of ``paddle_tpu/fluid/transpiler/
ps_dispatcher.py``; upstream transpiler/ps_dispatcher.py): assign
variables to "servers".  The port has no parameter server: the consumer
is a checkpoint writer that spreads replicated variables over the
processes (:func:`assign_writer`), with the same assignment as the
reference."""

from __future__ import annotations

import zlib


def _var_name(var) -> str:
    return var if isinstance(var, str) else var.name


class PSDispatcher:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class HashName(PSDispatcher):
    def _hash_block(self, block_str, total):
        # crc32, not the builtin hash(): str hash is salted per process
        # (PYTHONHASHSEED), and every process must agree on the layout
        return zlib.crc32(block_str.encode("utf-8")) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(_var_name(var), len(self._eps))]
                for var in varlist]


class RoundRobin(PSDispatcher):
    def dispatch(self, varlist):
        eplist = []
        for _ in varlist:
            eplist.append(self._eps[self._step])
            self._step = (self._step + 1) % len(self._eps)
        return eplist


def assign_writer(names, n_processes: int, kind: str = "round_robin"):
    """Deterministic ``{name: process_id}`` for replicated-variable
    checkpoint writes; every process computes the same map (the names must
    arrive in the same order everywhere)."""
    d = (HashName if kind == "hash" else RoundRobin)(range(n_processes))
    return dict(zip(names, d.dispatch(list(names))))
