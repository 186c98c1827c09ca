"""DistributeTranspiler: multi-worker training (counterpart of
``paddle_tpu/fluid/transpiler/distribute_transpiler.py``; upstream
transpiler/distribute_transpiler.py:132).

Upstream rewrites the program into send / recv / listen_and_serv ops
against parameter servers.  As in the reference, the port has no
parameter server: ``transpile`` rewrites no op; it records the trainer
topology on the program (``_dist_info``, the reference's dict) and joins
the process group (``parallel/multihost.py``, the first pserver endpoint
as the rendezvous address), and ``ParallelExecutor`` runs the program
data-parallel over it (one all-reduce of the grads a step, or ZeRO-1's
sharded update under ``BuildStrategy.ReduceStrategy.Reduce``).
``sync_mode=False`` (the reference's local SGD) raises when a
``ParallelExecutor`` is built over the program: it comes with the later
part of ``ROADMAP.md`` queue 1 item 12b.
"""

from __future__ import annotations

import os

from ..framework import Program, default_main_program


class DistributeTranspilerConfig:
    """Upstream distribute_transpiler.py:116."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._transpiled = False

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  mesh=None, place=None):
        """Record the trainer topology on the program and join the group
        (``place``: the backend's place, default the card; a group already
        initialized is adopted).  ``mesh`` (or ``PADDLE_TPU_MESH``, e.g.
        ``dp4``) names the axes; a malformed spec raises here."""
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.origin_program = program or default_main_program()
        self.pserver_endpoints = [e for e in pservers.split(",") if e]
        self._transpiled = True
        mesh_spec = mesh or os.environ.get("PADDLE_TPU_MESH", "").strip() \
            or None
        if mesh_spec is not None:
            from ...parallel.mesh import parse_mesh_spec

            parse_mesh_spec(mesh_spec)
        self.mesh_spec = mesh_spec
        self.origin_program._dist_info = {
            "trainer_id": trainer_id,
            "trainers": trainers,
            "coordinator": (self.pserver_endpoints[0]
                            if self.pserver_endpoints else None),
            "mode": "spmd_ici" if sync_mode else "async_local_sgd",
            "mesh": mesh_spec,
        }
        if sync_mode and int(trainers) > 1:
            from .. import core
            from ...parallel import multihost as _mh

            _mh.ensure_init(self.origin_program._dist_info,
                            place if place is not None else core.CUDAPlace(0))

    def get_trainer_program(self) -> Program:
        if not self._transpiled:
            raise RuntimeError("call transpile() first")
        return self.origin_program

    def get_pserver_program(self, endpoint) -> Program:
        raise NotImplementedError(
            "the port has no parameter-server process: parameters and "
            "optimizer state live on the ranks and gradients all-reduce "
            "over the group.  Launch every rank with the trainer program "
            "(ParallelExecutor).")

    def get_startup_program(self, endpoint, pserver_program=None,
                            startup_program=None):
        raise NotImplementedError(
            "no pserver startup program in the port's deployment")
